"""Optimizer-step semantics: clipping order and frozen-param masking.

Torch parity contract (ref `src/train_multimodal.py:422-454`): only
optimizer-group (trainable) params contribute to the clip norm; clipping
runs on raw gradients BEFORE optimizer.step() injects the coupled wd*p
term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from multimodal_rare_disease.train.state import TrainState, apply_gradients


def _mk_state(params, mask, *, optimizer="sgd", wd=0.0, clip=0.0,
              lr_mult=None):
    if optimizer == "sgd":
        tx = optax.chain(optax.trace(decay=0.0, nesterov=False))
    else:
        tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8))
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats={},
        opt_state=tx.init(params),
        skipped_steps=jnp.zeros((), jnp.int32),
        mask=jax.tree_util.tree_map(jnp.float32, mask),
        lr_mult=lr_mult or jax.tree_util.tree_map(
            lambda _: jnp.float32(1.0), params),
        grad_tx=tx,
        optimizer_kind=optimizer,
        weight_decay=wd,
        gradient_clip_val=clip,
    )


def test_frozen_grads_do_not_inflate_clip_norm():
    # trainable grad has norm 3; a huge frozen grad must not trigger
    # clipping of the trainable update
    params = {"a": jnp.zeros(4), "b": jnp.zeros(4)}
    mask = {"a": 1.0, "b": 0.0}
    grads = {"a": jnp.full(4, 1.5), "b": jnp.full(4, 1e6)}
    state = _mk_state(params, mask, clip=10.0)  # norm(a)=3 < 10 -> no clip
    new = apply_gradients(state, grads, lr=jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(new.params["a"]),
                               -1.5 * np.ones(4), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(new.params["b"]), np.zeros(4))


def test_clip_threshold_matches_hand_computation():
    # 90%-frozen tree: clip scale must be computed from the single
    # trainable leaf only (torch clip_grad_norm_ over param-group grads)
    params = {f"p{i}": jnp.zeros(3) for i in range(10)}
    mask = {f"p{i}": (1.0 if i == 0 else 0.0) for i in range(10)}
    grads = {f"p{i}": jnp.full(3, 4.0) for i in range(10)}
    clip = 1.0
    state = _mk_state(params, mask, clip=clip)
    new = apply_gradients(state, grads, lr=jnp.float32(1.0))
    gnorm = np.linalg.norm(np.full(3, 4.0))  # trainable-only norm
    expect = -4.0 * (clip / (gnorm + 1e-6))
    np.testing.assert_allclose(np.asarray(new.params["p0"]),
                               np.full(3, expect), rtol=1e-5)


def test_coupled_wd_added_after_clipping():
    # sgd + coupled L2: raw grad is clipped to clip/|g| * g, then wd*p
    # is added un-clipped (torch order)
    p0 = 10.0
    params = {"w": jnp.full(1, p0)}
    mask = {"w": 1.0}
    g = 8.0
    grads = {"w": jnp.full(1, g)}
    wd, clip = 0.5, 2.0
    state = _mk_state(params, mask, optimizer="sgd", wd=wd, clip=clip)
    new = apply_gradients(state, grads, lr=jnp.float32(1.0))
    clipped = g * (clip / (g + 1e-6))
    expect = p0 - (clipped + wd * p0)
    np.testing.assert_allclose(np.asarray(new.params["w"]),
                               np.full(1, expect), rtol=1e-5)


def test_no_clip_when_disabled():
    params = {"w": jnp.zeros(2)}
    grads = {"w": jnp.full(2, 100.0)}
    state = _mk_state(params, {"w": 1.0}, clip=0.0)
    new = apply_gradients(state, grads, lr=jnp.float32(0.1))
    np.testing.assert_allclose(np.asarray(new.params["w"]),
                               np.full(2, -10.0), rtol=1e-6)
