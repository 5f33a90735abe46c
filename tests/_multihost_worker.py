"""Multi-host worker: one process of an N-process data-parallel (and
optionally tensor-parallel) train step over a GLOBAL device mesh.

Launched by tests/test_multihost.py (2 processes x 4 virtual CPU
devices) and usable standalone. This is the real multi-host path the
framework claims (docs/SCALING.md): `jax.distributed.initialize` +
one `Mesh` over all processes' devices, batches assembled from
process-local shards with `make_array_from_process_local_data`, and
XLA/Gloo collectives reducing gradients across processes — against the
reference's strictly single-process design (SURVEY.md §2.3).

Usage: _multihost_worker.py <process_id> <num_processes> <port> <model_axis>
Prints one line: MH_RESULT {"loss": ..., "eval_count": ..., "qkv_spec": ...}
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    pid, nproc, port, model_axis = (int(a) for a in sys.argv[1:5])
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc, process_id=pid)

    import jax.numpy as jnp
    import numpy as np

    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.parallel.mesh import (
        batch_sharding,
        create_mesh,
    )
    from multimodal_rare_disease.train import Trainer
    from multimodal_rare_disease.train.pipeline import STAGING_SIZE

    n_devices = len(jax.devices())
    cfg = resolve_config("multimodal", {
        "data.image_size": 64,
        "data.max_text_length": 16,
        "data.online_rotation": False,
        "text_encoder.max_length": 16,
        "text_encoder.num_layers": 2,
        "text_encoder.num_heads": 2,
        "text_encoder.hidden_size": 64,
        "text_encoder.intermediate_size": 128,
        "text_encoder.vocab_size": 512,
        "cnn_encoder.embedding_dim": 64,
        "fusion.text_proj_dim": 64,
        "fusion.hidden_dim": 64,
        "fusion.num_attention_heads": 2,
        "training.batch_size": 2 * n_devices,
        "evaluation.eval_batch_size": 2 * n_devices,
        "training.compute_dtype": "float32",
    })
    mesh = create_mesh(cfg, data_axis=n_devices // model_axis,
                       model_axis=model_axis)

    trainer = Trainer(cfg, mode="multimodal", pipeline=None, mesh=mesh)
    trainer.init_state()
    trainer._build_steps()

    # identical global batch on every process (seeded); each process
    # contributes its LOCAL slice of the batch dimension
    B = cfg.training.batch_size
    T = cfg.data.max_text_length
    rng = np.random.default_rng(0)
    batch = {
        "labels": rng.integers(0, 10, B).astype(np.int32),
        "valid": np.ones(B, np.float32),
        "images": rng.integers(0, 256, (B, STAGING_SIZE, STAGING_SIZE, 3),
                               ).astype(np.uint8),
        "input_ids": rng.integers(0, 512, (B, T)).astype(np.int32),
        "attention_mask": np.ones((B, T), np.int32),
    }
    sh = batch_sharding(mesh)
    lo, hi = pid * B // nproc, (pid + 1) * B // nproc
    placed = {
        k: jax.make_array_from_process_local_data(sh, v[lo:hi])
        for k, v in batch.items()
    }
    assert placed["images"].shape[0] == B  # global batch reassembled

    state, metrics = trainer._train_step(
        trainer.state, placed, jnp.asarray(1e-3, jnp.float32),
        jax.random.key(0))
    loss = float(jax.device_get(metrics["loss"]))

    em = trainer._eval_step(state.params, state.batch_stats, placed)
    count = float(jax.device_get(em["count"]))

    qkv = state.params["text_encoder"]["bert"]["layer0"]["attention"][
        "qkv"]["kernel"]
    print("MH_RESULT " + json.dumps({
        "pid": pid,
        "loss": loss,
        "eval_count": count,
        "global_devices": n_devices,
        "local_devices": len(jax.local_devices()),
        "mesh": dict(mesh.shape),
        "qkv_spec": str(qkv.sharding.spec),
    }), flush=True)


if __name__ == "__main__":
    main()
