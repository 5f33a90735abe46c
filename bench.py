"""Benchmark: multimodal predict throughput (image+text pairs/s) on a GPU.

The flagship inference forward at B=256 with bf16 weights: uint8 faces
staged at 256 px → resize+crop+normalize on device → ResNet-50 + BERT-base
+ cross-modal attention fusion → class probabilities. The workload is
`data.synthetic.seeded_corpus` (procedural faces, built-in clinical notes
at mixed lengths), tokenized and length-bucketed as the predictor does;
the text tower runs sequence-packed when packing beats the bucket by the
predictor's own rule (inference/packing.py), as it does in serving.

Times a warmed loop of batches that ends in `block_until_ready`
(throughput), then batches blocked one at a time (p50/p99 latency).
Needs a GPU: without one it exits non-zero and prints no result.

Prints ONE JSON line: {"metric", "value", "unit", "extra"}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2

    from multimodal_rare_disease.cli._common import enable_compilation_cache
    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.data.synthetic import seeded_corpus
    from multimodal_rare_disease.data.tokenizer import get_tokenizer
    from multimodal_rare_disease.inference.packing import (
        pack_texts,
        packing_wins,
    )
    from multimodal_rare_disease.inference.predictor import _LENGTH_BUCKETS
    from multimodal_rare_disease.models import create_model
    from multimodal_rare_disease.ops.preprocess import eval_preprocess
    from multimodal_rare_disease.train.pipeline import STAGING_SIZE

    enable_compilation_cache()
    cfg = resolve_config("default")
    dtype = jnp.bfloat16
    model = create_model(cfg, mode="multimodal", dtype=dtype)
    B, T = args.batch, cfg.data.max_text_length

    images_np, _, notes = seeded_corpus(B, args.seed, STAGING_SIZE)
    ids_np, mask_np, _ = get_tokenizer().encode_batch(notes, T)
    lens = mask_np.sum(axis=1)
    bucket = next((b for b in _LENGTH_BUCKETS if lens.max() <= b < T), T)
    ids_np, mask_np = ids_np[:, :bucket], mask_np[:, :bucket]
    cap = max(256, -(-int(lens.max()) // 128) * 128)
    packed = packing_wins(lens, bucket, capacity=cap)

    # parameter values do not depend on the input sizes: init small
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 32, 32, 3)), jnp.ones((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), train=False))(jax.random.key(args.seed))
    variables = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if x.dtype == jnp.float32 else x,
        variables)
    images = jnp.asarray(images_np)

    if packed:
        pb = pack_texts(ids_np, mask_np, capacity=cap)
        text = tuple(jnp.asarray(a) for a in (
            pb.input_ids, pb.position_ids, pb.segment_ids,
            pb.query_positions, pb.doc_row, pb.doc_slot))

        @jax.jit
        def forward(variables, images_u8, text):
            x = eval_preprocess(images_u8, cfg, dtype=dtype)
            return model.apply(variables, x, *text,
                               method="packed_forward")["probs"]
        packing = (f"{B} docs in {pb.num_rows} x {cap} rows "
                   f"({pb.tokens_per_doc:.0f} tok/doc)")
    else:
        text = (jnp.asarray(ids_np), jnp.asarray(mask_np))

        @jax.jit
        def forward(variables, images_u8, text):
            x = eval_preprocess(images_u8, cfg, dtype=dtype)
            return model.apply(variables, x, *text, train=False)["probs"]
        packing = "off"

    t0 = time.perf_counter()
    forward(variables, images, text).block_until_ready()
    first_call_s = time.perf_counter() - t0
    forward(variables, images, text).block_until_ready()

    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = forward(variables, images, text)
    out.block_until_ready()
    loop_s = time.perf_counter() - t0

    lat = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        forward(variables, images, text).block_until_ready()
        lat.append(time.perf_counter() - t0)

    dev = devices[0]
    print(json.dumps({
        "metric": "multimodal_predict_throughput",
        "value": B * args.iters / loop_s,
        "unit": "pairs/s",
        "extra": {
            "batch": B,
            "iters": args.iters,
            "p50_batch_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_batch_ms": float(np.percentile(lat, 99)) * 1e3,
            "first_call_s": first_call_s,
            "text_tokens": bucket,
            "text_packing": packing,
            "dtype": "bfloat16",
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(devices),
            "card": _card(),
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
