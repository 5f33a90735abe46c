"""Smoke run of the system on a GPU, through the entry points users call.

    python chip_smoke.py [--seed N]     # one GPU: predict, parity, train, serve
    python chip_smoke.py --four         # four GPUs of one host: DP and DP x TP

The flagship model at full width (ResNet-50 at 224 px, BERT-base 12 x 768
with FFN 3072 and a 28,996-token vocabulary, attention fusion, 10-way
head) with weights initialised from `--seed`, on a corpus generated from
the same seed (`data.synthetic.seeded_corpus`). Phases:

- predict: `MultimodalPredictor.predict_batch` at B=256, bf16 weights,
  on the sequence-packed path and on the length-bucketed path (the
  bucketed forward is the one that also returns embeddings); the
  probabilities are finite, sum to 1, and the two paths agree.
- parity: the pinned golden forward (tests/test_golden.py) under
  "highest" matmul precision, and the bf16 serving forward against the
  float32 "highest" forward of the same parameters at full width.
- train: `Trainer` with the `multimodal` preset (batch 8, T=256, x10
  online augmentation), one epoch of the device-resident epoch scan plus
  validation, then a second epoch for a warm per-step time.
- serve: `load_predictor` on the checkpoint the train phase saved, the
  `cli.serve` HTTP server and micro-batcher on a thread, concurrent
  POST /predict requests and a GET /healthz.

Each phase prints one "bring-up observation" line (wall, compile and
per-step seconds: observations of one run, not a benchmark). Any failed
phase makes the exit code non-zero, and the closing JSON line is printed
only when every phase passed. There is no CPU fallback: without a GPU
the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

# Probabilities of a bf16 forward vs another bf16 forward or the float32
# reference of the same parameters. bf16 keeps 8 mantissa bits (relative
# step 2^-8 = 3.9e-3 per rounding). The weights are random: the ResNet's
# BatchNorm runs on its initial statistics, so activations grow through
# its 16 blocks and the logits come out large and the probabilities
# peaked; a logit error of 2^-8 x |logit| ~ 0.05 then moves a peaked
# probability by up to ~2e-2. A real numerics fault (a wrong mask, a
# dropped bias, a bad layout) moves them by O(0.1-1).
BF16_PROB_ATOL = 3e-2
# Packed vs bucketed text: the same arithmetic in bf16, summed in another
# order over other shapes — the same bound.
PACKED_PROB_ATOL = 3e-2
# The golden forward is pinned on the CPU; tests/test_golden.py's bound.
GOLDEN_ATOL = 2e-3
# Four cards vs one, on the same parameters and inputs: the same bf16
# arithmetic reduced in another order across devices. The loss (~2.3) is
# a mean of f32 log-softmax of bf16 logits, so it carries the logits'
# ~0.05 error (see BF16_PROB_ATOL); a dropped or doubled all-reduce moves
# it by far more.
FOUR_LOSS_ATOL = 5e-2
FOUR_PROB_ATOL = BF16_PROB_ATOL

# Tiny fixed-seed model whose first probability row is pinned (float32
# compute, CPU). Any intended numerics change repins GOLDEN_ROW0.
GOLDEN_OVERRIDES: Dict[str, Any] = {
    "data.image_size": 64,
    "data.max_text_length": 16,
    "data.augmentation_factor": 1,
    "data.online_rotation": False,
    "text_encoder.num_layers": 2,
    "text_encoder.num_heads": 2,
    "text_encoder.hidden_size": 32,
    "text_encoder.intermediate_size": 64,
    "text_encoder.vocab_size": 4096,
    "text_encoder.max_length": 16,
    "fusion.text_proj_dim": 32,
    "fusion.hidden_dim": 32,
    "fusion.num_attention_heads": 2,
    "cnn_encoder.embedding_dim": 32,
    "classifier.hidden_dims": (32,),
    "training.batch_size": 8,
    "training.num_epochs": 1,
    "training.compute_dtype": "float32",
    "training.warmup_epochs": 0,
}
GOLDEN_ROW0 = np.array(
    [0.10901581, 0.04983993, 0.04176393, 0.12084029, 0.11914441,
     0.08468267, 0.17986728, 0.14346622, 0.09551004, 0.05586931],
    np.float32)


def golden_probs() -> np.ndarray:
    """First probability row of the pinned golden forward."""
    import jax
    import jax.numpy as jnp

    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.models import create_model

    cfg = resolve_config("default", GOLDEN_OVERRIDES)
    model = create_model(cfg, mode="multimodal", dtype=jnp.float32)
    T = cfg.data.max_text_length
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.integers(0, 256, (2, 64, 64, 3)) / 255.0,
                         jnp.float32)
    ids = jnp.asarray(rng.integers(0, 100, (2, T)), jnp.int32)
    mask = jnp.ones((2, T), jnp.int32)
    variables = model.init(jax.random.key(42), images, ids, mask)
    return np.asarray(model.apply(variables, images, ids, mask)["probs"])[0]


def check_golden() -> float:
    """Golden forward under "highest" matmul precision against the pinned
    CPU row; returns max |dp|, raises beyond GOLDEN_ATOL."""
    import jax

    with jax.default_matmul_precision("highest"):
        diff = float(np.abs(golden_probs() - GOLDEN_ROW0).max())
    if diff > GOLDEN_ATOL:
        raise AssertionError(f"golden forward max|dp| {diff:.3e} > "
                             f"{GOLDEN_ATOL}")
    return diff


# ---------------------------------------------------------------------------
# set-up shared by the phases
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SmokeConfig:
    """Sizes of one smoke run; the defaults are the flagship at full
    width. CPU tests pass a tiny model through `overrides`."""

    seed: int = 0
    overrides: Optional[Dict[str, Any]] = None  # over the "default" preset
    train_overrides: Optional[Dict[str, Any]] = None  # over "multimodal"
    predict_batch: int = 256
    images_per_class: int = 5  # training corpus (the reference's 50 faces)
    serve_requests: int = 8


class Context:
    """Model, weights and corpus built once per run from the seed."""

    def __init__(self, sc: SmokeConfig, workdir: Path):
        from multimodal_rare_disease.config import resolve_config
        from multimodal_rare_disease.data.synthetic import seeded_corpus
        from multimodal_rare_disease.data.tokenizer import get_tokenizer
        from multimodal_rare_disease.train.pipeline import STAGING_SIZE

        self.sc = sc
        self.workdir = workdir
        self.cfg = resolve_config("default", sc.overrides or {})
        self.tokenizer = get_tokenizer()
        n = sc.predict_batch
        self.images, self.labels, self.notes = seeded_corpus(
            n, sc.seed, STAGING_SIZE)
        self._variables = None
        self._bf16 = None

    @property
    def variables(self):
        """float32 parameters of the flagship, initialised from the seed."""
        if self._variables is None:
            import jax
            import jax.numpy as jnp

            from multimodal_rare_disease.models import create_model

            model = create_model(self.cfg, mode="multimodal",
                                 dtype=jnp.float32)
            # Parameter shapes and values do not depend on the image size
            # or the text length, so the init traces the smallest inputs.
            self._variables = jax.jit(lambda k: model.init(
                k, jnp.zeros((1, 32, 32, 3)), jnp.ones((1, 8), jnp.int32),
                jnp.ones((1, 8), jnp.int32), train=False))(
                    jax.random.key(self.sc.seed))
        return self._variables

    def serving_predictor(self):
        """The bf16-weight predictor (built once: its compiled buckets
        are shared by the predict and parity phases)."""
        if self._bf16 is None:
            import jax
            import jax.numpy as jnp

            from multimodal_rare_disease.inference import MultimodalPredictor

            v = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.bfloat16)
                if a.dtype == jnp.float32 else a, self.variables)
            self._bf16 = MultimodalPredictor(
                self.cfg, v["params"], v.get("batch_stats", {}),
                tokenizer=self.tokenizer)
        return self._bf16


def _probs(results: List[Dict[str, Any]]) -> np.ndarray:
    return np.asarray([list(r["all_probabilities"].values())
                       for r in results], np.float32)


def _check_probs(p: np.ndarray, n: int, what: str) -> None:
    if p.shape != (n, 10):
        raise AssertionError(f"{what}: probabilities shape {p.shape}")
    if not np.isfinite(p).all():
        raise AssertionError(f"{what}: non-finite probabilities")
    worst = float(np.abs(p.sum(axis=1) - 1.0).max())
    if worst > 1e-3:
        raise AssertionError(f"{what}: rows sum to 1 +- {worst:.2e}")


def _timed(fn: Callable[[], Any], repeats: int):
    """(first-call seconds, steady per-call seconds, last result)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    return first, (time.perf_counter() - t0) / max(repeats, 1), out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_predict(ctx: Context) -> Dict[str, Any]:
    pred = ctx.serving_predictor()
    n = len(ctx.notes)
    images = list(ctx.images)

    first, step, packed = _timed(
        lambda: _probs(pred.predict_batch(images, ctx.notes)), 3)
    b_first, b_step, bucketed = _timed(
        lambda: _probs(pred.predict_batch(images, ctx.notes,
                                          return_embeddings=True)), 3)
    if pred._forward_packed._cache_size() < 1:
        raise AssertionError("the seeded notes did not engage packing")
    _check_probs(packed, n, "packed")
    _check_probs(bucketed, n, "bucketed")
    diff = float(np.abs(packed - bucketed).max())
    if diff > PACKED_PROB_ATOL:
        raise AssertionError(f"packed vs bucketed max|dp| {diff:.3e} > "
                             f"{PACKED_PROB_ATOL}")
    return {"wall_s": first + b_first + 3 * (step + b_step),
            "compile_s": (first - step) + (b_first - b_step),
            "step_s": step, "bucketed_step_s": b_step,
            "batch": n, "pairs_per_s": n / step,
            "packed_vs_bucketed_max_abs": diff}


def phase_parity(ctx: Context) -> Dict[str, Any]:
    import jax

    from multimodal_rare_disease.inference import MultimodalPredictor

    t0 = time.perf_counter()
    gdiff = check_golden()

    # float32 compute on the same (f32 master) parameters; one predictor
    # (one set of compiled programs) per matmul precision
    cfg32 = replace(ctx.cfg, training=replace(ctx.cfg.training,
                                              compute_dtype="float32"))
    v = ctx.variables
    images = list(ctx.images)
    f32 = [MultimodalPredictor(cfg32, v["params"], v.get("batch_stats", {}),
                               tokenizer=ctx.tokenizer) for _ in range(2)]

    # both text paths: packed (plain call) and bucketed (the forward that
    # also returns embeddings)
    serving = ctx.serving_predictor()
    bf16 = [_probs(serving.predict_batch(images, ctx.notes, **kw))
            for kw in ({}, {"return_embeddings": True})]
    with jax.default_matmul_precision("highest"):
        first, step, highest = _timed(
            lambda: _probs(f32[0].predict_batch(images, ctx.notes)), 1)
        highest_b = _probs(f32[0].predict_batch(images, ctx.notes,
                                                return_embeddings=True))
    default32 = _probs(f32[1].predict_batch(images, ctx.notes))
    n = len(images)
    for p, what in ((bf16[0], "bf16 packed"), (bf16[1], "bf16 bucketed"),
                    (highest, "f32 highest"), (highest_b, "f32 highest b"),
                    (default32, "f32 default")):
        _check_probs(p, n, what)
    bdiff = float(np.abs(bf16[0] - highest).max())
    bdiff_b = float(np.abs(bf16[1] - highest_b).max())
    tdiff = float(np.abs(default32 - highest).max())
    if max(bdiff, bdiff_b) > BF16_PROB_ATOL:
        raise AssertionError(f"bf16 vs f32-highest max|dp| packed "
                             f"{bdiff:.3e} bucketed {bdiff_b:.3e} > "
                             f"{BF16_PROB_ATOL}")
    return {"wall_s": time.perf_counter() - t0,
            "compile_s": first - step, "step_s": step,
            "golden_max_abs": gdiff,
            "bf16_vs_highest_max_abs_packed": bdiff,
            "bf16_vs_highest_max_abs_bucketed": bdiff_b,
            "f32_highest_packed_vs_bucketed_max_abs":
                float(np.abs(highest - highest_b).max()),
            "f32_default_vs_highest_max_abs": tdiff}


def phase_train(ctx: Context) -> Dict[str, Any]:
    import jax

    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.data.synthetic import (
        SyntheticImageGenerator,
    )
    from multimodal_rare_disease.train import Trainer
    from multimodal_rare_disease.train.pipeline import (
        STAGING_SIZE,
        DataPipeline,
    )
    from multimodal_rare_disease.utils.checkpoint import role_path

    sc = ctx.sc
    ckpt_dir = ctx.workdir / "checkpoints"
    cfg = resolve_config("multimodal", {
        **(sc.train_overrides or {}),
        "training.checkpoint_dir": str(ckpt_dir),
        "evaluation.results_dir": str(ctx.workdir / "results"),
        "training.seed": sc.seed,
    })
    image_dir = ctx.workdir / "faces"
    SyntheticImageGenerator(STAGING_SIZE, sc.seed).generate_dataset(
        image_dir, num_per_class=sc.images_per_class)
    pipeline = DataPipeline(cfg, mode="multimodal", image_dir=str(image_dir))
    trainer = Trainer(cfg, mode="multimodal", pipeline=pipeline,
                      workdir=str(ckpt_dir))
    trainer.init_state()
    if not trainer._use_index_mode:
        raise AssertionError("the corpus did not go device-resident")
    before = jax.tree_util.tree_map(np.asarray, trainer.state.params)

    t0 = time.perf_counter()
    trainer.train(num_epochs=1)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.train(num_epochs=2)
    warm = time.perf_counter() - t0

    losses = trainer.history["train_loss"] + trainer.history["val_loss"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss in {trainer.history}")
    after = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    moved = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: bool(np.any(a != b)), before, after))
    if not any(moved):
        raise AssertionError("no parameter moved")
    for role in ("best", "last"):
        if not (role_path(ckpt_dir, "multimodal", role)
                / "arrays.npz").exists():
            raise AssertionError(f"no {role} checkpoint")
    stats = jax.devices()[0].memory_stats() or {}
    steps = pipeline.steps_per_epoch
    ctx.checkpoint = role_path(ckpt_dir, "multimodal", "best")
    return {"wall_s": cold + warm, "compile_s": cold - warm,
            "step_s": warm / steps, "steps_per_epoch": steps,
            "train_loss": trainer.history["train_loss"][-1],
            "val_loss": trainer.history["val_loss"][-1],
            "params_moved": f"{sum(moved)}/{len(moved)} leaves",
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def phase_serve(ctx: Context) -> Dict[str, Any]:
    import urllib.request
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from multimodal_rare_disease.cli.serve import MicroBatcher, make_handler
    from multimodal_rare_disease.inference import load_predictor

    t0 = time.perf_counter()
    predictor = load_predictor(ctx.checkpoint)
    batcher = MicroBatcher(predictor, window_ms=20.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    n = ctx.sc.serve_requests

    def encode(i: int) -> str:
        buf = io.BytesIO()
        Image.fromarray(ctx.images[i % len(ctx.images)]).save(buf, "PNG")
        return base64.b64encode(buf.getvalue()).decode()

    bodies = [json.dumps({"image": encode(i),
                          "text": ctx.notes[i % len(ctx.notes)],
                          "top_k": 3}).encode() for i in range(n)]

    def post(body: bytes) -> Dict[str, Any]:
        req = urllib.request.Request(
            base + "/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    def burst():
        with ThreadPoolExecutor(n) as pool:
            return list(pool.map(post, bodies))

    try:
        first, step, results = _timed(burst, 2)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    if health.get("status") != "ok":
        raise AssertionError(f"healthz: {health}")
    for res in results:
        if len(res.get("predictions", [])) != 3:
            raise AssertionError(f"bad /predict answer: {res}")
        total = sum(res["all_probabilities"].values())
        if not abs(total - 1.0) < 1e-3:
            raise AssertionError(f"probabilities sum to {total}")
    return {"wall_s": time.perf_counter() - t0, "compile_s": first - step,
            "step_s": step, "requests_per_burst": n,
            "device_batches": health["batch_calls"]}


def phase_four(ctx: Context, devices) -> Dict[str, Any]:
    """A train step on 4x1 (data parallel) and 2x2 (data x tensor
    parallel) meshes and a 2x2 sharded predict, each against one card
    on the same parameters and inputs. Full width (H=768, FFN 3072, 12
    heads, ResNet-50 widths, 224 px); depth cut to 2 BERT layers and one
    bottleneck per ResNet stage, which keeps every sharded shape and
    collective while compiling three meshes in minutes."""
    import jax
    import jax.numpy as jnp

    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.inference import MultimodalPredictor
    from multimodal_rare_disease.parallel.mesh import (
        batch_sharding,
        create_mesh,
    )
    from multimodal_rare_disease.train import Trainer

    if len(devices) < 4:
        raise AssertionError(f"need 4 devices, have {len(devices)}")
    devices = devices[:4]
    t0 = time.perf_counter()
    sc = ctx.sc
    B = 32
    cfg = resolve_config("multimodal", {
        "text_encoder.num_layers": 2, "text_encoder.freeze_layers": 0,
        "cnn_encoder.stage_sizes": (1, 1, 1, 1),
        **(sc.train_overrides or {}),
        "training.batch_size": B, "evaluation.eval_batch_size": B,
        "training.seed": sc.seed,
        "training.checkpoint_dir": str(ctx.workdir / "checkpoints4"),
        "evaluation.results_dir": str(ctx.workdir / "results4"),
    })
    T = cfg.data.max_text_length
    ids, mask, _ = ctx.tokenizer.encode_batch(ctx.notes[:B], T)
    batch = {"labels": ctx.labels[:B], "valid": np.ones(B, np.float32),
             "images": ctx.images[:B], "input_ids": ids,
             "attention_mask": mask}

    def train_step(data_axis, model_axis, devs):
        mesh = create_mesh(cfg, devices=devs, data_axis=data_axis,
                           model_axis=model_axis)
        trainer = Trainer(cfg, mode="multimodal", pipeline=None, mesh=mesh)
        trainer.init_state()
        trainer._build_steps()
        placed = {k: jax.device_put(v, batch_sharding(mesh))
                  for k, v in batch.items()}
        state, metrics = trainer._train_step(
            trainer.state, placed, jnp.asarray(1e-4, jnp.float32),
            jax.random.key(sc.seed))
        loss = float(metrics["loss"])
        if data_axis * model_axis > 1:
            if len(placed["images"].sharding.device_set) != 4:
                raise AssertionError("batch not spread over 4 devices")
            qkv = state.params["text_encoder"]["bert"]["layer0"][
                "attention"]["qkv"]["kernel"]
            if len(qkv.sharding.device_set) != 4:
                raise AssertionError("params not placed on 4 devices")
            if model_axis > 1 and "model" not in tuple(qkv.sharding.spec):
                raise AssertionError(f"qkv not TP-sharded: "
                                     f"{qkv.sharding.spec}")
        return loss, state

    loss1, state1 = train_step(1, 1, devices[:1])
    loss_dp, _ = train_step(4, 1, devices)
    loss_tp, _ = train_step(2, 2, devices)
    for name, loss in (("4x1", loss_dp), ("2x2", loss_tp)):
        if not np.isfinite(loss) or abs(loss - loss1) > FOUR_LOSS_ATOL:
            raise AssertionError(f"{name} loss {loss} vs one card {loss1}")

    params, bs = state1.params, state1.batch_stats
    single = MultimodalPredictor(cfg, params, bs, tokenizer=ctx.tokenizer)
    mesh22 = create_mesh(cfg, devices=devices, data_axis=2, model_axis=2)
    sharded = MultimodalPredictor(cfg, params, bs, tokenizer=ctx.tokenizer,
                                  mesh=mesh22)
    if len(sharded._place(ctx.images).sharding.device_set) != 4:
        raise AssertionError("predict batch not spread over 4 devices")
    images = list(ctx.images)
    p1 = _probs(single.predict_batch(images, ctx.notes))
    p4 = _probs(sharded.predict_batch(images, ctx.notes))
    _check_probs(p4, len(images), "sharded predict")
    pdiff = float(np.abs(p1 - p4).max())
    if pdiff > FOUR_PROB_ATOL:
        raise AssertionError(f"2x2 predict max|dp| {pdiff:.3e} > "
                             f"{FOUR_PROB_ATOL}")
    return {"wall_s": time.perf_counter() - t0, "compile_s": None,
            "step_s": None, "loss_1card": loss1, "loss_4x1": loss_dp,
            "loss_2x2": loss_tp, "predict_2x2_max_abs": pdiff}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run_phases(phases, sc: SmokeConfig, devices=None) -> bool:
    """Run `phases` (names) in order; print one observation line each.
    Returns True when all passed."""
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ctx = Context(sc, Path(tmp))
        for name in phases:
            t0 = time.perf_counter()
            try:
                if name == "four":
                    obs = phase_four(ctx, devices)
                else:
                    obs = globals()[f"phase_{name}"](ctx)
                status = "ok"
            except Exception:  # noqa: BLE001 — report every phase
                traceback.print_exc()
                obs, status, ok = {}, "FAILED", False
            obs.setdefault("wall_s", time.perf_counter() - t0)
            fields = " ".join(f"{k}={v}" for k, v in obs.items())
            print(f"bring-up observation: phase={name} {status} {fields}",
                  flush=True)
            if status != "ok" and name == "train":
                break  # serve needs the train phase's checkpoint
    return ok


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU DP / DP x TP phase")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    from multimodal_rare_disease.cli._common import enable_compilation_cache

    enable_compilation_cache()
    print(_card_line(), flush=True)
    print(f"jax {jax.__version__}, numpy {np.__version__}, "
          f"{len(devices)}x {devices[0].device_kind}", flush=True)

    sc = SmokeConfig(seed=args.seed)
    phases = ["four"] if args.four else ["predict", "parity", "train",
                                         "serve"]
    if not run_phases(phases, sc, devices):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
