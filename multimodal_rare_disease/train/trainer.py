"""Unified trainer covering all three modes (multimodal / image_only /
text_only).

One implementation replaces the reference's three ~70%-duplicated trainers
(`Trainer` `src/train.py:103-522`, `SmallDataTrainer`
`src/train_small_data.py:252-528`, `MultimodalTrainer`
`src/train_multimodal.py:356-676`) with a compiled design:

- ONE jitted train step containing device-side augmentation + forward +
  loss + backward + optimizer update; donated state, runtime-scalar LR
- bf16 compute via the model dtype; no GradScaler needed (the reference's
  CUDA AMP machinery, `src/train.py:159-161`, has no bf16 analogue)
- class-weighted CE + label smoothing (ref `src/train_multimodal.py:389-392`)
- NaN guard in-graph: non-finite loss/grads suppress the update and bump a
  counter (ref batch-skip guards `src/train_small_data.py:369-391`)
- early stopping, best/last checkpoints by val_loss or val_acc,
  5-series history dict (ref `src/train.py:164-170`)
- data parallel by construction: batches sharded over the mesh 'data'
  axis, gradients all-reduced by XLA
"""

from __future__ import annotations

import logging
import time
from collections import deque
from functools import partial
from typing import Any, Dict, Iterator, Optional

import jax
import jax.flatten_util  # noqa: F401  (registers jax.flatten_util)
import jax.numpy as jnp
import numpy as np

from multimodal_rare_disease.config import Config, ensure_dirs
from multimodal_rare_disease.models import create_model
from multimodal_rare_disease.ops.preprocess import (
    eval_preprocess,
    train_preprocess,
)
from multimodal_rare_disease.parallel.mesh import (
    batch_sharding,
    create_mesh,
    replicated_sharding,
)
from multimodal_rare_disease.train.freeze import count_params, trainable_mask
from multimodal_rare_disease.train.pipeline import DataPipeline
from multimodal_rare_disease.train.schedules import EarlyStopping, make_schedule
from multimodal_rare_disease.train.state import (
    TrainState,
    apply_gradients,
    create_train_state,
)
from multimodal_rare_disease.utils.checkpoint import role_path, save_checkpoint
from multimodal_rare_disease.utils.rng import RngStreams

log = logging.getLogger(__name__)


def weighted_ce_loss(logits: jnp.ndarray, labels: jnp.ndarray,
                     class_w: jnp.ndarray, label_smoothing: float,
                     valid: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """torch CrossEntropyLoss(weight, label_smoothing) semantics:
    per-sample weighted NLL over smoothed targets, normalized by the sum
    of sample weights."""
    num_classes = logits.shape[-1]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    onehot = jax.nn.one_hot(labels, num_classes)
    smooth = (1.0 - label_smoothing) * onehot + label_smoothing / num_classes
    nll = -jnp.sum(smooth * logp, axis=-1)
    w = class_w[labels]
    if valid is not None:
        w = w * valid
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1e-8)


# Fraction of device memory the estimated footprint may claim before the
# HBM-resident corpus mode refuses and falls back to streaming. The rest
# covers XLA workspace, fragmentation, and estimate error.
_HBM_SAFETY = 0.75


def device_memory_limit_bytes(device=None) -> float:
    """Per-device memory bound from the runtime
    (`memory_stats()['bytes_limit']`). CPU devices report none and get a
    huge bound (the host OS is the real limiter there); an accelerator
    that reports none is an error, not a guess."""
    device = device or jax.devices()[0]
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if limit:
        return float(limit)
    if device.platform == "cpu":
        return 1e15
    raise RuntimeError(
        f"{device.platform} device {device.device_kind!r} reports no "
        "memory bytes_limit; cannot size the device-resident corpus")


def estimate_train_hbm_bytes(cfg, state, corpus_nbytes: int) -> float:
    """Conservative pre-flight estimate of the resident train step's peak
    device footprint: corpus + 4x params (f32 master + Adam mu/nu +
    gradients; the donated update overlaps old/new state briefly) +
    batch_stats + per-batch activations (dominated by the conv pyramid;
    ~32 f32 image-sized planes covers ResNet50's worst stage at batch
    size B, doubled for the backward residency).

    Exists so that an oversized resident corpus falls back to streaming
    up front instead of failing the step for want of device memory.
    """
    param_bytes = sum(
        np.prod(l.shape) * l.dtype.itemsize
        for l in jax.tree_util.tree_leaves(state.params)
        if hasattr(l, "shape"))
    bs_bytes = sum(
        np.prod(l.shape) * l.dtype.itemsize
        for l in jax.tree_util.tree_leaves(state.batch_stats)
        if hasattr(l, "shape"))
    B = cfg.training.batch_size
    S = cfg.data.image_size
    act_bytes = B * S * S * 3 * 4 * 32 * 2
    T = cfg.data.max_text_length
    H = cfg.text_encoder.hidden_size
    L = cfg.text_encoder.num_layers
    act_bytes += B * T * H * 4 * (4 * L)  # qkv/ffn residency per layer
    return float(corpus_nbytes + 4 * param_bytes + bs_bytes + act_bytes)


def _model_inputs(mode: str, batch: Dict[str, jnp.ndarray], images):
    if mode == "multimodal":
        return (images, batch["input_ids"], batch["attention_mask"])
    if mode == "image_only":
        return (images,)
    return (batch["input_ids"], batch["attention_mask"])


class Trainer:
    """Mode-switched trainer (`train_model` parity, `src/train.py:525-570`)."""

    def __init__(
        self,
        cfg: Config,
        mode: str = "multimodal",
        pipeline: Optional[DataPipeline] = None,
        mesh=None,
        workdir: Optional[str] = None,
    ):
        self.cfg = cfg
        self.mode = mode
        self.mesh = mesh if mesh is not None else create_mesh(cfg)
        self.pipeline = pipeline
        self.rngs = RngStreams(cfg.seed)
        self.workdir = workdir or cfg.training.checkpoint_dir
        ensure_dirs(cfg)

        if cfg.training.debug_nans:
            jax.config.update("jax_debug_nans", True)
        n_data = self.mesh.shape["data"]
        for name, b in (("training.batch_size", cfg.training.batch_size),
                        ("evaluation.eval_batch_size",
                         cfg.evaluation.eval_batch_size)):
            if b % n_data != 0:
                raise ValueError(
                    f"{name}={b} must be divisible by the mesh data axis "
                    f"({n_data} devices) so batches shard evenly")
        self.model = create_model(cfg, mode=mode)
        self.state: Optional[TrainState] = None
        self.history: Dict[str, list] = {
            "train_loss": [], "train_acc": [], "val_loss": [], "val_acc": [],
            "lr": [],
        }
        self.best_metric_value: Optional[float] = None
        self._compiled = False
        self._host_step = 0
        self._use_index_mode = False
        self._corpus = None

        if pipeline is not None:
            self.class_weights = np.asarray(pipeline.class_weights, np.float32)
        else:
            self.class_weights = np.ones((cfg.classifier.num_classes,),
                                         np.float32)
        if not cfg.training.use_class_weights:
            self.class_weights = np.ones_like(self.class_weights)

    # -- initialization ----------------------------------------------------

    def _dummy_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        B = c.training.batch_size
        batch: Dict[str, np.ndarray] = {
            "labels": np.zeros(B, np.int32),
            "valid": np.ones(B, np.float32),
        }
        if self.mode != "text_only":
            from multimodal_rare_disease.train.pipeline import STAGING_SIZE

            batch["images"] = np.zeros((B, STAGING_SIZE, STAGING_SIZE, 3),
                                       np.uint8)
        if self.mode != "image_only":
            T = c.data.max_text_length
            batch["input_ids"] = np.ones((B, T), np.int32)
            batch["attention_mask"] = np.ones((B, T), np.int32)
        return batch

    def init_state(self) -> TrainState:
        if self.state is not None:
            return self.state
        batch = self._dummy_batch()
        images = None
        if self.mode != "text_only":
            images = jnp.zeros(
                (1, self.cfg.data.image_size, self.cfg.data.image_size, 3),
                jnp.float32)
        args = _model_inputs(self.mode, {k: jnp.asarray(v[:1]) for k, v in
                                         batch.items()}, images)
        # jit the init: eagerly it dispatches hundreds of individual ops,
        # each compiled and launched on its own. One jitted program = one
        # compile.
        init_fn = jax.jit(lambda rng, *a: self.model.init(rng, *a,
                                                          train=False))
        variables = init_fn(self.rngs.device("init"), *args)
        self.state = create_train_state(self.cfg, variables)
        if self.mesh.shape.get("model", 1) > 1:
            # tensor-parallel placements over the 'model' axis (BERT
            # heads + FFN inner dim; see parallel/tp.py) — XLA SPMD
            # propagates these through the jitted step and inserts the
            # per-layer all-reduces
            from multimodal_rare_disease.parallel.tp import (
                describe_tp,
                shard_train_state,
            )

            self.state = shard_train_state(self.mesh, self.state)
            log.info("%s", describe_tp(self.state.params, self.mesh))
        else:
            # replicate across the mesh
            rep = replicated_sharding(self.mesh)
            self.state = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, rep) if isinstance(x, jnp.ndarray)
                else x, self.state)
        total, trainable = count_params(
            self.state.params, trainable_mask(self.cfg, self.state.params))
        log.info("%s model: %.1fM params (%.1fM trainable)", self.mode,
                 total / 1e6, trainable / 1e6)

        # Device-resident corpus for index-batch mode. Auto-selected by
        # size: beyond the budget the whole-corpus upload would crowd out
        # activations, so large corpora fall back to the streaming host
        # pipeline (unbounded in corpus size).
        self._use_index_mode = (self.pipeline is not None
                                and hasattr(self.pipeline, "device_corpus"))
        if self._use_index_mode:
            host_corpus = self.pipeline.device_corpus()
            nbytes = sum(np.asarray(v).nbytes for v in host_corpus.values())
            budget = float(self.cfg.training.device_corpus_budget_gb) * 1e9
            total_est = estimate_train_hbm_bytes(self.cfg, self.state,
                                                 nbytes)
            limit = device_memory_limit_bytes()
            if nbytes > budget:
                log.warning(
                    "corpus is %.2f GB > device_corpus_budget_gb=%.1f; "
                    "falling back to streaming host batches (slower per "
                    "epoch; raise the budget to keep it HBM-resident)",
                    nbytes / 1e9, self.cfg.training.device_corpus_budget_gb)
                self._use_index_mode = False
            elif total_est > _HBM_SAFETY * limit:
                # Pre-flight guard: a corpus within the configured budget
                # can STILL sink the step once params + optimizer moments
                # + gradients + activations pile on top. Refuse up front.
                log.warning(
                    "estimated train-step footprint %.2f GB (corpus %.2f "
                    "+ params/optimizer/activations) exceeds %d%% of "
                    "device memory (%.1f GB); falling back to streaming "
                    "host batches", total_est / 1e9, nbytes / 1e9,
                    int(_HBM_SAFETY * 100), limit / 1e9)
                self._use_index_mode = False
            else:
                rep = replicated_sharding(self.mesh)
                self._corpus = {
                    k: jax.device_put(jnp.asarray(v), rep)
                    for k, v in host_corpus.items()
                }
                log.info("device-resident corpus: %.1f MB in HBM",
                         nbytes / 1e6)
        return self.state

    # -- compiled steps ----------------------------------------------------

    def _build_steps(self):
        cfg = self.cfg
        mode = self.mode
        model = self.model
        class_w = jnp.asarray(self.class_weights)
        ls = cfg.training.label_smoothing
        dtype = jnp.dtype(cfg.training.compute_dtype)

        mixup_alpha = cfg.data.mixup_alpha
        use_mixup = mixup_alpha > 0 and mode != "text_only"

        # Tensor-parallel runs pin the updated state to its initial
        # placement (parallel/tp.py): without the constraint XLA's SPMD
        # partitioner is free to re-shard step outputs per its own cost
        # model, which drifts the param placement and inserts resharding
        # collectives between steps.
        tp_shardings = None
        if self.mesh.shape.get("model", 1) > 1 and self.state is not None:
            tp_shardings = jax.tree_util.tree_map(
                lambda x: x.sharding, self.state)

        def _pin(state: TrainState) -> TrainState:
            if tp_shardings is None:
                return state
            return jax.tree_util.tree_map(
                jax.lax.with_sharding_constraint, state, tp_shardings)

        def _train_body(state: TrainState, batch, raw_images, lr, key):
            kaug, kdrop, kmix = jax.random.split(key, 3)
            images = None
            if mode != "text_only":
                images = train_preprocess(raw_images, kaug, cfg, dtype)

            labels = batch["labels"]
            if use_mixup:
                # image mixup (ref MixupDataset semantics): lam ~ Beta(a,a),
                # pair each sample with a permuted partner, mix pixels and CE
                kperm, klam = jax.random.split(kmix)
                perm = jax.random.permutation(kperm, images.shape[0])
                lam = jax.random.beta(klam, mixup_alpha, mixup_alpha)
                images = lam * images + (1.0 - lam) * images[perm]
                labels2 = labels[perm]

            def loss_fn(params):
                variables = {"params": params,
                             "batch_stats": state.batch_stats}
                out, mutated = model.apply(
                    variables, *_model_inputs(mode, batch, images),
                    train=True, rngs={"dropout": kdrop},
                    mutable=["batch_stats"])
                loss = weighted_ce_loss(out["logits"], labels, class_w, ls)
                if use_mixup:
                    loss = lam * loss + (1.0 - lam) * weighted_ce_loss(
                        out["logits"], labels2, class_w, ls)
                return loss, (out["logits"], mutated["batch_stats"])

            (loss, (logits, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)

            finite = jnp.isfinite(loss)
            if cfg.training.nan_guard:
                # per-leaf fused reductions (sum of non-finite is non-finite)
                # — NOT ravel_pytree, which concatenates a 550 MB vector
                leaf_ok = [jnp.isfinite(jnp.sum(g))
                           for g in jax.tree_util.tree_leaves(grads)]
                finite = finite & jnp.stack(leaf_ok).all()
            skip = ~finite

            state = _pin(apply_gradients(state, grads, lr,
                                         new_batch_stats=new_bs, skip=skip))
            preds = jnp.argmax(logits, axis=-1)
            acc = jnp.mean((preds == batch["labels"]).astype(jnp.float32))
            metrics = {"loss": loss, "acc": acc,
                       "skipped": skip.astype(jnp.int32)}
            return state, metrics

        def train_step(state: TrainState, batch, lr, key):
            return _train_body(state, batch, batch.get("images"), lr, key)

        def _eval_body(params, batch_stats, batch, raw_images):
            images = None
            if mode != "text_only":
                images = eval_preprocess(raw_images, cfg, dtype)
            variables = {"params": params, "batch_stats": batch_stats}
            out = model.apply(variables, *_model_inputs(mode, batch, images),
                              train=False)
            valid = batch["valid"]
            loss = weighted_ce_loss(out["logits"], batch["labels"], class_w,
                                    0.0, valid=valid)
            preds = jnp.argmax(out["logits"], axis=-1)
            correct = jnp.sum((preds == batch["labels"]).astype(jnp.float32)
                              * valid)
            return {"loss_sum": loss * jnp.sum(valid), "correct": correct,
                    "count": jnp.sum(valid)}

        def eval_step(params, batch_stats, batch):
            return _eval_body(params, batch_stats, batch, batch.get("images"))

        # index-batch mode: the corpus stays HBM-resident; steps receive
        # tiny index arrays and gather the batch on device
        def _gather_text(corpus, labels, levels, variants, batch):
            if mode != "image_only" and "pool_ids" in corpus:
                batch["input_ids"] = corpus["pool_ids"][labels, levels,
                                                        variants]
                batch["attention_mask"] = corpus["pool_mask"][labels, levels,
                                                              variants]

        def train_step_idx(state: TrainState, corpus, idx, lr, key):
            rows = idx["rows"]
            labels = corpus["train_labels"][rows]
            batch = {"labels": labels}
            raw = corpus["train_images"][rows] if mode != "text_only" else None
            _gather_text(corpus, labels,
                         idx.get("levels"), idx.get("variants"), batch)
            return _train_body(state, batch, raw, lr, key)

        def eval_step_idx(params, batch_stats, corpus, idx):
            rows = idx["rows"]
            labels = corpus["val_labels"][rows]
            batch = {"labels": labels, "valid": idx["valid"]}
            raw = corpus["val_images"][rows] if mode != "text_only" else None
            if mode != "image_only" and "pool_ids" in corpus:
                # validation text: level 0 = full clinical description by
                # default; pipelines with per-sample texts (FGDD pairing)
                # supply explicit levels/variants per row
                zeros = jnp.zeros_like(labels)
                lev = idx.get("levels", zeros)
                var = idx.get("variants", zeros)
                batch["input_ids"] = corpus["pool_ids"][labels, lev, var]
                batch["attention_mask"] = corpus["pool_mask"][labels, lev,
                                                              var]
            return _eval_body(params, batch_stats, batch, raw)

        # whole-epoch scan: ONE dispatch per epoch instead of one per
        # step (each carries ~600 state arrays through argument handling).
        def train_epoch_scan(state: TrainState, corpus, idx_all, lrs,
                             base_key):
            def body(st, xs):
                idx, lr, i = xs
                key = jax.random.fold_in(base_key, i)
                st, metrics = train_step_idx(st, corpus, idx, lr, key)
                return st, metrics

            n = lrs.shape[0]
            state, metrics = jax.lax.scan(
                body, state, (idx_all, lrs, jnp.arange(n)))
            return state, metrics

        def eval_scan(params, batch_stats, corpus, idx_all):
            def body(_, idx):
                return (), eval_step_idx(params, batch_stats, corpus, idx)

            _, metrics = jax.lax.scan(body, (), idx_all)
            return {k: jnp.sum(v) for k, v in metrics.items()}

        self._train_step = jax.jit(train_step, donate_argnums=(0,))
        self._eval_step = jax.jit(eval_step)
        self._train_step_idx = jax.jit(train_step_idx, donate_argnums=(0,))
        self._eval_step_idx = jax.jit(eval_step_idx)
        self._train_epoch_scan = jax.jit(train_epoch_scan,
                                         donate_argnums=(0,))
        self._eval_scan = jax.jit(eval_scan)

    def _place(self, batch: Dict[str, np.ndarray]):
        sh = batch_sharding(self.mesh)
        return {k: jax.device_put(v, sh) for k, v in batch.items()}

    def _prefetched(self, batches: Iterator) -> Iterator:
        """Double-buffered host→device transfer for the streaming path.

        Keeps `data.prefetch_batches` batches device-resident ahead of
        consumption: `jax.device_put` is asynchronous, so the H2D copy
        of batch N+1..N+depth overlaps the (dispatched) compute of batch
        N instead of serializing transfer → step → transfer the way the
        reference's per-batch `.to(device)` does
        (`src/train_multimodal.py:509-512`). The HBM-resident index-batch
        mode bypasses this entirely; this is the fallback for corpora
        above `training.device_corpus_budget_gb`.
        """
        depth = max(1, int(self.cfg.data.prefetch_batches))
        it = iter(batches)
        buf: deque = deque()
        try:
            while len(buf) < depth:
                buf.append(self._place(next(it)))
        except StopIteration:
            pass
        while buf:
            out = buf.popleft()
            try:
                buf.append(self._place(next(it)))
            except StopIteration:
                pass
            yield out

    # -- epoch loops -------------------------------------------------------

    def _train_epoch(self, epoch: int, schedule) -> Dict[str, float]:
        assert self.pipeline is not None
        losses, accs = [], []
        lr = 0.0
        # host-side step counter: reading state.step would force a device
        # sync every step
        step = self._host_step
        if self._use_index_mode:
            idx_list = list(self.pipeline.train_index_batches())
            idx_all = {k: jnp.asarray(np.stack([d[k] for d in idx_list]))
                       for k in idx_list[0]}
            lrs = jnp.asarray([schedule(step + i)
                               for i in range(len(idx_list))], jnp.float32)
            base_key = self.rngs.device_step("train", step)
            self.state, metrics = self._train_epoch_scan(
                self.state, self._corpus, idx_all, lrs, base_key)
            losses = [float(x) for x in np.asarray(metrics["loss"])]
            accs = [float(x) for x in np.asarray(metrics["acc"])]
            step += len(idx_list)
            lr = float(lrs[-1])
            self._host_step = step
            return {"loss": float(np.mean(losses)),
                    "acc": float(np.mean(accs)), "lr": lr}
        else:
            for batch in self._prefetched(self.pipeline.train_batches()):
                lr = schedule(step)
                key = self.rngs.device_step("train", step)
                self.state, metrics = self._train_step(
                    self.state, batch,
                    jnp.asarray(lr, jnp.float32), key)
                losses.append(metrics["loss"])
                accs.append(metrics["acc"])
                step += 1
        self._host_step = step
        losses = [float(x) for x in jax.device_get(losses)]
        accs = [float(x) for x in jax.device_get(accs)]
        return {"loss": float(np.mean(losses)) if losses else float("nan"),
                "acc": float(np.mean(accs)) if accs else float("nan"),
                "lr": lr}

    def _validate(self, batches: Optional[Iterator] = None) -> Dict[str, float]:
        assert self.pipeline is not None or batches is not None
        tot_loss, tot_correct, tot_n = 0.0, 0.0, 0.0
        if batches is None and self._use_index_mode:
            idx_list = list(self.pipeline.val_index_batches())
            idx_all = {k: jnp.asarray(np.stack([d[k] for d in idx_list]))
                       for k in idx_list[0]}
            m = jax.device_get(self._eval_scan(
                self.state.params, self.state.batch_stats, self._corpus,
                idx_all))
            n = float(m["count"])
            if n == 0:
                return {"loss": float("nan"), "acc": float("nan")}
            return {"loss": float(m["loss_sum"]) / n,
                    "acc": float(m["correct"]) / n}
        else:
            it = batches if batches is not None \
                else self.pipeline.val_batches()
            results = [
                self._eval_step(self.state.params, self.state.batch_stats,
                                batch)
                for batch in self._prefetched(it)
            ]
        for m in results:
            m = jax.device_get(m)
            tot_loss += float(m["loss_sum"])
            tot_correct += float(m["correct"])
            tot_n += float(m["count"])
        if tot_n == 0:
            return {"loss": float("nan"), "acc": float("nan")}
        return {"loss": tot_loss / tot_n, "acc": tot_correct / tot_n}

    # -- public API --------------------------------------------------------

    def train(self, num_epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        num_epochs = num_epochs or cfg.training.num_epochs
        self.init_state()
        if not self._compiled:
            self._build_steps()
            self._compiled = True

        schedule = make_schedule(cfg.training,
                                 self.pipeline.steps_per_epoch)
        best_metric = cfg.training.best_metric
        stop_mode = "min" if best_metric == "val_loss" else "max"
        early = EarlyStopping(cfg.training.patience, cfg.training.min_delta,
                              mode=stop_mode) if cfg.training.early_stopping \
            else None

        # resume: continue after the epochs already in history
        start_epoch = len(self.history["train_loss"])
        if start_epoch:
            self._host_step = start_epoch * self.pipeline.steps_per_epoch
            if int(jax.device_get(self.state.step)) == 0:
                self.state = self.state.replace(
                    step=jnp.asarray(self._host_step, jnp.int32))

        t_start = time.time()
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            if cfg.training.profile_dir and epoch == cfg.training.profile_epoch:
                from multimodal_rare_disease.utils.profiling import trace

                with trace(cfg.training.profile_dir):
                    train_m = self._train_epoch(epoch, schedule)
            else:
                train_m = self._train_epoch(epoch, schedule)
            val_m = self._validate()
            schedule.on_validation(val_m["loss"])

            self.history["train_loss"].append(train_m["loss"])
            self.history["train_acc"].append(train_m["acc"])
            self.history["val_loss"].append(val_m["loss"])
            self.history["val_acc"].append(val_m["acc"])
            self.history["lr"].append(train_m["lr"])

            metric_value = (val_m["loss"] if best_metric == "val_loss"
                            else val_m["acc"])
            improved = (early.update(metric_value) if early is not None
                        else self._manual_best(metric_value, stop_mode))
            if improved:
                self.best_metric_value = metric_value
                if cfg.training.save_checkpoints:
                    self.save("best", epoch)
            every = max(1, cfg.training.checkpoint_every_epochs)
            is_last_epoch = (epoch + 1) == num_epochs
            if cfg.training.save_checkpoints \
                    and not cfg.training.save_best_only and (
                    (epoch + 1) % every == 0 or is_last_epoch):
                self.save("last", epoch)

            log.info(
                "epoch %3d/%d  train loss %.4f acc %.3f | val loss %.4f "
                "acc %.3f | lr %.2e | %.1fs%s",
                epoch + 1, num_epochs, train_m["loss"], train_m["acc"],
                val_m["loss"], val_m["acc"], train_m["lr"],
                time.time() - t0, "  *BEST*" if improved else "")

            if early is not None and early.should_stop:
                log.info("early stopping at epoch %d", epoch + 1)
                if cfg.training.save_checkpoints \
                        and not cfg.training.save_best_only:
                    self.save("last", epoch)
                break

        skipped = int(jax.device_get(self.state.skipped_steps))
        if skipped:
            log.warning("NaN guard suppressed %d updates", skipped)
        return {
            "history": self.history,
            "best_metric": self.best_metric_value,
            "total_time": time.time() - t_start,
            "skipped_steps": skipped,
        }

    def _manual_best(self, value: float, mode: str) -> bool:
        if self.best_metric_value is None:
            return True
        return value < self.best_metric_value if mode == "min" \
            else value > self.best_metric_value

    def save(self, role: str, epoch: int) -> None:
        path = role_path(self.workdir, self.mode, role)
        meta = {
            "mode": self.mode,
            "epoch": epoch,
            "best_metric": self.best_metric_value,
            "best_metric_name": self.cfg.training.best_metric,
            "history": self.history,
            "config": self.cfg.to_dict(),
        }
        class_names = getattr(self.pipeline, "class_names", None) \
            if self.pipeline else None
        if class_names:
            meta["class_names"] = list(class_names)
        tok = getattr(self.pipeline, "tokenizer", None) if self.pipeline else None
        if tok is not None:
            # persist the vocab so inference reproduces training tokenization
            meta["vocab"] = [t for t, _ in sorted(tok.vocab.items(),
                                                  key=lambda kv: kv[1])]
        save_checkpoint(
            path,
            self.state.params,
            self.state.batch_stats,
            int(jax.device_get(self.state.step)),
            meta=meta,
            # optimizer moments only on resumable "last" checkpoints
            opt_state=self.state.opt_state if role == "last" else None,
        )

    def load(self, path) -> None:
        from multimodal_rare_disease.utils.checkpoint import load_checkpoint

        params, batch_stats, meta = load_checkpoint(path)
        self.init_state()
        self.state = self.state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, batch_stats))
        opt_state = meta.pop("_opt_state", None)
        if opt_state is not None:
            # restore optimizer moments with the original pytree structure
            flat_new = jax.tree_util.tree_leaves(opt_state)
            treedef = jax.tree_util.tree_structure(self.state.opt_state)
            if treedef.num_leaves == len(flat_new):
                self.state = self.state.replace(
                    opt_state=jax.tree_util.tree_unflatten(
                        treedef, [jnp.asarray(x) for x in flat_new]))
            else:
                log.warning("opt_state in checkpoint does not match the "
                            "current optimizer; starting moments fresh")
        if meta.get("history"):
            self.history = meta["history"]


def train_model(
    cfg: Config,
    mode: str = "multimodal",
    image_dir: Optional[str] = None,
    num_epochs: Optional[int] = None,
    workdir: Optional[str] = None,
) -> Trainer:
    """End-to-end convenience entry (`train_model` parity,
    `src/train.py:525-570`): build pipeline + trainer, run, reload best."""
    pipeline = DataPipeline(cfg, mode=mode, image_dir=image_dir)
    trainer = Trainer(cfg, mode=mode, pipeline=pipeline, workdir=workdir)
    trainer.train(num_epochs)
    best = role_path(trainer.workdir, mode, "best")
    if best.exists():
        trainer.load(best)  # reload best (ref `src/train_multimodal.py:672-674`)
    return trainer
