"""Tensor parallelism (Megatron-style) over the mesh 'model' axis.

The reference has no parallelism of any kind (SURVEY.md §2.3); the
flagship 136 M-param model fits one chip, so the 'model' axis defaults
to 1. This module makes the reserved axis real for scale-out: the BERT
tower's attention heads and FFN inner dimension are sharded over
'model' while the residual stream stays replicated — the standard
Megatron decomposition, expressed as NamedSharding placements on the
param tree. XLA's SPMD partitioner propagates the shardings through
the jitted train step and inserts the two all-reduces per layer
(after the attention-output and FFN-output contractions); no
hand-written collectives.

Sharded (when divisible by the model-axis size):
  layer*/attention/qkv/kernel   [H, 3, h, d]  → heads      P(None, None, 'model', None)
  layer*/attention/qkv/bias     [3, h, d]     → heads      P(None, 'model', None)
  layer*/attention/output/kernel[h, d, H]     → heads      P('model', None, None)
  layer*/intermediate/kernel    [H, I]        → inner dim  P(None, 'model')
  layer*/intermediate/bias      [I]           → inner dim  P('model')
  layer*/output/kernel          [I, H]        → inner dim  P('model', None)

Everything else (embeddings, LayerNorms, pooler, the 25.6 M-param CNN,
fusion, head, and all scalar state) is replicated: at these sizes the
text tower dominates both memory and FLOPs, and sharding the conv
channels would trade interconnect traffic for negligible savings.

Optimizer moments (Adam mu/nu), being param-shaped subtrees of the
TrainState, match the same path tails and shard identically, so the
optimizer update stays fully local per shard.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _path_names(path: Tuple[Any, ...]) -> Tuple[str, ...]:
    names = []
    for e in path:
        if hasattr(e, "key"):        # DictKey
            names.append(str(e.key))
        elif hasattr(e, "name"):     # GetAttrKey (struct fields)
            names.append(str(e.name))
        elif hasattr(e, "idx"):      # SequenceKey (optax chain tuples)
            names.append(str(e.idx))
        else:
            names.append(str(e))
    return tuple(names)


def tp_spec(path_names: Tuple[str, ...], shape: Tuple[int, ...],
            model_size: int) -> P:
    """PartitionSpec for one leaf, by path tail + shape.

    Matching on the *tail* makes the same rules cover `state.params`,
    the Adam moments (`state.opt_state[...].mu/nu`), and any other
    param-shaped subtree. Non-divisible or non-matching leaves
    replicate.
    """
    t = path_names
    nd = len(shape)

    def div(axis: int) -> bool:
        return shape[axis] % model_size == 0

    if len(t) >= 3 and t[-3:] == ("attention", "qkv", "kernel") \
            and nd == 4 and div(2):
        return P(None, None, "model", None)
    if len(t) >= 3 and t[-3:] == ("attention", "qkv", "bias") \
            and nd == 3 and div(1):
        return P(None, "model", None)
    if len(t) >= 3 and t[-3:] == ("attention", "output", "kernel") \
            and nd == 3 and div(0):
        return P("model", None, None)
    if len(t) >= 2 and t[-2:] == ("intermediate", "kernel") \
            and nd == 2 and div(1):
        return P(None, "model")
    if len(t) >= 2 and t[-2:] == ("intermediate", "bias") \
            and nd == 1 and div(0):
        return P("model")
    # FFN output projection: layer*/output/kernel [I, H]. The tail
    # ('output', 'kernel') alone would also match attention/output
    # (excluded above by its rank-3 kernel) and conv paths (rank 4).
    if len(t) >= 3 and t[-2:] == ("output", "kernel") \
            and t[-3].startswith("layer") and nd == 2 and div(0):
        return P("model", None)
    return P()


def shard_train_state(mesh: Mesh, state: Any) -> Any:
    """Place a TrainState on the mesh with TP param placements.

    Leaves whose path tail matches a TP rule get their 'model'-axis
    sharding; everything else is replicated. Works on any pytree whose
    param-shaped subtrees use the module naming above.
    """
    model_size = int(mesh.shape.get("model", 1))

    def _put(path, x):
        if not isinstance(x, (jax.Array, np.ndarray)) or x.ndim == 0:
            spec = P()
        else:
            spec = tp_spec(_path_names(path), x.shape, model_size)
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(_put, state)


def describe_tp(params: Any, mesh: Mesh) -> str:
    """Human-readable summary: how many params are model-sharded."""
    model_size = int(mesh.shape.get("model", 1))
    total = sharded = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        n = int(np.prod(leaf.shape)) if hasattr(leaf, "shape") else 1
        total += n
        if tp_spec(_path_names(path), getattr(leaf, "shape", ()),
                   model_size) != P():
            sharded += n
    return (f"tensor-parallel over model={model_size}: "
            f"{sharded / 1e6:.1f}M of {total / 1e6:.1f}M params sharded "
            f"({100.0 * sharded / max(total, 1):.0f}%)")
