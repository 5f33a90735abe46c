"""Train state and optimizer.

One TrainState pytree (params, BatchNorm stats, optimizer state, step and
NaN-skip counters) + a runtime-LR optimizer: the jitted step receives the
learning rate as a scalar argument, so every schedule — including
val-driven plateau — reuses a single compiled program.

Optimizer semantics match the reference's torch configuration
(`src/train.py:183-211`): adam / adamw / sgd+momentum, with weight decay
coupled (adam/sgd) or decoupled (adamw), global-norm gradient clipping,
frozen-param masking (ref freeze logic `src/cnn_encoder.py:102-166`), and
per-component LR multipliers (ref `src/train_multimodal.py:422-454`).
Masks and multipliers are scalar pytree leaves so the state jits cleanly.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from multimodal_rare_disease import nn
from multimodal_rare_disease.config import Config
from multimodal_rare_disease.train.freeze import lr_multipliers, trainable_mask


class TrainState(nn.PyTreeNode):
    step: jnp.ndarray
    params: Any
    batch_stats: Any
    opt_state: Any
    skipped_steps: jnp.ndarray  # NaN-guard counter (ref SmallDataTrainer :369-391)
    mask: Any        # 1.0 = trainable, 0.0 = frozen (scalar leaf per param)
    lr_mult: Any     # per-component LR multiplier (scalar leaf per param)

    grad_tx: optax.GradientTransformation = nn.static_field()
    optimizer_kind: str = nn.static_field()
    weight_decay: float = nn.static_field()
    gradient_clip_val: float = nn.static_field(default=0.0)


def _make_grad_tx(cfg: Config) -> Tuple[optax.GradientTransformation, str]:
    # NOTE: global-norm clipping is NOT part of this chain — it runs
    # explicitly in apply_gradients on masked raw gradients, before the
    # coupled weight-decay term is added (torch order: clip_grad_norm_ on
    # param-group grads, then optimizer.step() injects wd*p).
    t = cfg.training
    chain = []
    if t.optimizer in ("adam", "adamw"):
        chain.append(optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8))
    elif t.optimizer == "sgd":
        chain.append(optax.trace(decay=0.9, nesterov=False))
    else:
        raise ValueError(f"Unknown optimizer: {t.optimizer!r}")
    return optax.chain(*chain), t.optimizer


def create_train_state(cfg: Config, variables: dict) -> TrainState:
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    grad_tx, kind = _make_grad_tx(cfg)
    mask = jax.tree_util.tree_map(
        lambda m: jnp.asarray(1.0 if m else 0.0, jnp.float32),
        trainable_mask(cfg, params))
    mults = jax.tree_util.tree_map(
        lambda m: jnp.asarray(m, jnp.float32), lr_multipliers(cfg, params))
    opt_state = grad_tx.init(params)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=batch_stats,
        opt_state=opt_state,
        skipped_steps=jnp.zeros((), jnp.int32),
        mask=mask,
        lr_mult=mults,
        grad_tx=grad_tx,
        optimizer_kind=kind,
        weight_decay=cfg.training.weight_decay,
        gradient_clip_val=float(cfg.training.gradient_clip_val or 0.0),
    )


def apply_gradients(
    state: TrainState,
    grads: Any,
    lr: jnp.ndarray,
    new_batch_stats: Optional[Any] = None,
    skip: Optional[jnp.ndarray] = None,
) -> TrainState:
    """One optimizer step; when `skip` is true (non-finite loss/grads) the
    whole update is suppressed and the skip counter increments.

    Torch param-group order (ref `src/train_multimodal.py:422-454`):
    1. zero frozen params' grads (only optimizer-group params exist there)
    2. clip_grad_norm_ over the remaining (raw) gradients
    3. optimizer.step() injects the coupled wd*p term (adam/sgd)
    """
    wd = state.weight_decay

    # 1. frozen params carry no gradient — they must not inflate the
    #    global norm below
    grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, state.mask)

    # 2. clip raw gradients by global norm (torch clip_coef formula)
    if state.gradient_clip_val > 0:
        gnorm = optax.global_norm(grads)
        scale = jnp.minimum(1.0, state.gradient_clip_val / (gnorm + 1e-6))
        grads = jax.tree_util.tree_map(lambda g: g * scale, grads)

    # 3. coupled L2: grad += wd * param (torch Adam/SGD semantics)
    if state.optimizer_kind in ("adam", "sgd") and wd > 0:
        grads = jax.tree_util.tree_map(
            lambda g, p, m: g + wd * p * m, grads, state.params, state.mask)

    updates, new_opt_state = state.grad_tx.update(grads, state.opt_state,
                                                  state.params)

    if state.optimizer_kind == "adamw" and wd > 0:
        # decoupled decay (torch AdamW), scaled by lr and multiplier below
        updates = jax.tree_util.tree_map(
            lambda u, p, m: u + wd * p * m, updates, state.params, state.mask)

    new_params = jax.tree_util.tree_map(
        lambda u, p, m, mult: p - lr * mult * m * u,
        updates, state.params, state.mask, state.lr_mult)

    bs = new_batch_stats if new_batch_stats is not None else state.batch_stats

    if skip is not None:
        keep = lambda new, old: jax.tree_util.tree_map(  # noqa: E731
            lambda n, o: jnp.where(skip, o, n), new, old)
        new_params = keep(new_params, state.params)
        new_opt_state = keep(new_opt_state, state.opt_state)
        bs = keep(bs, state.batch_stats)
        skipped = state.skipped_steps + skip.astype(jnp.int32)
    else:
        skipped = state.skipped_steps

    return state.replace(
        step=state.step + 1,
        params=new_params,
        batch_stats=bs,
        opt_state=new_opt_state,
        skipped_steps=skipped,
    )
