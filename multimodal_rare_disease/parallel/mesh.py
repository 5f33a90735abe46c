"""Device mesh and sharding layer.

The reference has no parallelism at all (SURVEY.md §2.3 — single process,
single GPU, explicit per-batch `.to(device)` copies). This module is the
replacement: a `jax.sharding.Mesh` over ('data', 'model') axes, batch
arrays sharded over 'data' via NamedSharding so XLA all-reduces the
gradients, and parameters replicated (the 136 M-param flagship
fits one chip; the 'model' axis is reserved for larger backbones).

This is equivalent in role to the reference's `get_safe_device()`
(`src/train.py:30-51`) plus the missing distributed layer.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multimodal_rare_disease.config import Config, MeshConfig


def describe_devices() -> str:
    devs = jax.devices()
    return f"{len(devs)}x {devs[0].platform}:{devs[0].device_kind}"


def create_mesh(
    cfg: Optional[Config] = None,
    *,
    data_axis: Optional[int] = None,
    model_axis: Optional[int] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """Build the run mesh.

    data_axis=-1 (default) takes all devices not consumed by model_axis.
    Works identically on one GPU, the GPUs of one host, or the CPU
    host-platform virtual-device test configuration.
    """
    mc = cfg.mesh if cfg is not None else MeshConfig()
    if data_axis is None:
        data_axis = mc.data_axis
    if model_axis is None:
        model_axis = mc.model_axis
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if model_axis <= 0:
        model_axis = 1
    if data_axis == -1:
        if n % model_axis != 0:
            raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
        data_axis = n // model_axis
    if data_axis * model_axis > n:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} needs {data_axis * model_axis} devices, have {n}"
        )
    devs = devs[: data_axis * model_axis]
    arr = np.array(devs).reshape(data_axis, model_axis)
    return Mesh(arr, axis_names=tuple(mc.axis_names))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over the 'data' mesh axis."""
    return NamedSharding(mesh, P("data"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """Place a host batch pytree onto the mesh, batch-dim sharded.

    Pads nothing: callers guarantee batch divisibility by the data-axis
    size (the data pipeline pads final batches with masked samples).
    """
    sh = batch_sharding(mesh)

    def _put(x):
        x = np.asarray(x)
        spec = P("data") if x.ndim >= 1 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    del sh
    return jax.tree_util.tree_map(_put, batch)


def param_sharding(mesh: Mesh, params: Any) -> Any:
    """Replicated NamedShardings matching a param pytree."""
    rep = replicated_sharding(mesh)
    return jax.tree_util.tree_map(lambda _: rep, params)


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape["data"]
