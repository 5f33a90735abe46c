import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease.parallel import (
    batch_sharding,
    create_mesh,
    replicated_sharding,
    shard_batch,
)


def test_mesh_uses_all_devices(mesh8):
    assert mesh8.shape["data"] == 8
    assert mesh8.shape["model"] == 1


def test_shard_batch_and_psum(mesh8):
    batch = {"x": np.arange(16, dtype=np.float32).reshape(16, 1), "y": np.ones(16)}
    sharded = shard_batch(mesh8, batch)
    assert sharded["x"].sharding.spec == batch_sharding(mesh8).spec

    @jax.jit
    def total(b):
        return jnp.sum(b["x"]) + jnp.sum(b["y"])

    assert float(total(sharded)) == float(np.sum(batch["x"]) + 16)


def test_model_axis_mesh():
    mesh = create_mesh(data_axis=4, model_axis=2)
    assert mesh.shape == {"data": 4, "model": 2}


def test_replicated_matmul_sharded_batch(mesh8):
    w = jnp.ones((4, 4))
    x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    xs = jax.device_put(x, batch_sharding(mesh8))
    ws = jax.device_put(w, replicated_sharding(mesh8))

    @jax.jit
    def f(x, w):
        return x @ w

    out = f(xs, ws)
    np.testing.assert_allclose(np.asarray(out), x @ np.ones((4, 4)), rtol=1e-5)


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_limit_needs_a_reported_limit():
    """The resident-corpus guard reads the device's bytes_limit; an
    accelerator that reports none is an error, not a guessed size."""
    from multimodal_rare_disease.train.trainer import (
        device_memory_limit_bytes,
    )

    assert device_memory_limit_bytes(
        _FakeDevice("gpu", {"bytes_limit": 60e9})) == 60e9
    assert device_memory_limit_bytes(_FakeDevice("cpu", None)) == 1e15
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device_memory_limit_bytes(_FakeDevice("gpu", {}))
