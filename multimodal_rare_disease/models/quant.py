"""Int8 (W8A8) quantized serving path (off by default).

Dynamic symmetric quantization for the transformer's big matmuls:
per-output-channel weight scales + per-row (per-token) activation
scales, computed in-graph. Weights quantize from the same f32 master
params (no separate checkpoint format); the transform is gated by
`TextEncoderConfig.quantized_inference` and never used in training.
Its speed against bf16 has not been measured on the GPU.

`MaybeQuantDenseGeneral` declares the exact param structure of
`nn.DenseGeneral` (kernel/bias names, shapes, init), so checkpoints and
HF-converted weights are interchangeable between the bf16 and int8 paths.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from multimodal_rare_disease import nn

Dtype = Any


def _quantize_weight(w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[K, N] f32 → (int8 [K, N], f32 scale [N]) symmetric per-column."""
    amax = jnp.max(jnp.abs(w), axis=0)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    wq = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return wq, scale


def _quantize_act(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[M, K] → (int8, f32 scale [M, 1]) symmetric per-row (per token)."""
    amax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    xq = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return xq, scale


def int8_matmul(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """f32/bf16 [M,K] × f32 [K,N] via dynamic W8A8 → f32 [M,N]."""
    xq, sx = _quantize_act(x.astype(jnp.float32))
    wq, sw = _quantize_weight(w.astype(jnp.float32))
    acc = jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return acc.astype(jnp.float32) * sx * sw[None, :]


class MaybeQuantDenseGeneral(nn.Module):
    """nn.DenseGeneral-compatible layer with an int8 fast path.

    Param structure (names, shapes, init) matches nn.DenseGeneral for the
    two layouts used in the BERT encoder:
      axis=-1,  features tuple/int  → kernel [in, *features]
      axis=(-2,-1), features int    → kernel [in1, in2, features]
    """

    features: Union[int, Sequence[int]]
    axis: Union[int, Sequence[int]] = -1
    quantized: bool = False
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32
    kernel_init: Any = nn.initializers.lecun_normal()

    @nn.compact
    def __call__(self, x: jnp.ndarray, return_weights: bool = False):
        """Apply the dense layer, or — with `return_weights=True` — just
        create/fetch the params and return `(kernel_2d [K,N], bias [N])`
        without computing (the CLS-only attention path slices them)."""
        features = (self.features,) if isinstance(self.features, int) \
            else tuple(self.features)
        axis = (self.axis,) if isinstance(self.axis, int) else tuple(self.axis)
        axis = tuple(a % x.ndim for a in axis)
        in_shape = tuple(x.shape[a] for a in axis)

        kernel = self.param("kernel", self.kernel_init,
                            in_shape + features, self.param_dtype)
        bias = self.param("bias", nn.initializers.zeros, features,
                          self.param_dtype)

        batch_shape = tuple(s for i, s in enumerate(x.shape) if i not in axis)
        K = int(np.prod(in_shape))
        N = int(np.prod(features))
        if return_weights:
            return kernel.reshape(K, N), bias.reshape(N)
        # axes in `axis` are contiguous trailing dims in all our uses
        x2 = x.reshape(batch_shape + (K,)).reshape(-1, K)
        w2 = kernel.reshape(K, N)

        if self.quantized:
            y = int8_matmul(x2, w2)
            y = y.reshape(batch_shape + features)
            return (y + bias.astype(jnp.float32)).astype(self.dtype)
        # Emit the dot in compute dtype directly (the matrix units still
        # accumulate in f32). An f32 preferred_element_type would let XLA
        # fuse the f32 output + downstream LayerNorm reductions into the
        # matmul epilogue, which was slower on the first accelerator this
        # ran on; not yet re-measured on the GPU.
        y = jnp.dot(x2.astype(self.dtype), w2.astype(self.dtype))
        y = y.reshape(batch_shape + features)
        return y + bias.astype(self.dtype)
