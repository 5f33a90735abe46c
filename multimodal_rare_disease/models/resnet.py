"""ResNet-50 image backbone.

Re-designed equivalent of the reference's torchvision-ResNet50 backbone
(`src/cnn_encoder.py:73-100`): NHWC layout (channels-last),
bf16 compute / f32 params, BatchNorm statistics computed over the global
(mesh-wide) batch under jit, and a stage-structured forward that exposes
intermediate feature maps for Grad-CAM (`get_intermediate_features`
analogue, `src/cnn_encoder.py:200-242`) without PyTorch hooks.

Stages (torchvision naming → ours): conv1+bn+pool = "stem", layer1..4 =
stage1..4. `freeze_stages=N` freezes stem + first N-? — freezing is
implemented in the optimizer (optax mask over param paths), not here.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
from multimodal_rare_disease import nn

Dtype = Any


class _StemConv(nn.Module):
    """7×7/s2 stem conv with an inference-time space-to-depth fast path.

    The canonical param stays [7, 7, 3, 64] (torchvision-conversion
    compatible, `models/convert.py`). With only 3 input channels the
    matrix units run the contraction nearly empty; the s2d path packs
    2×2 pixel blocks into 12 channels and runs
    the numerically-identical 4×4/s1 conv (kernel zero-padded to 8×8 on
    the leading edges → exact index match: out(i) reads s2d rows
    i-2..i+1, padding (2,1)).
    """

    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, s2d: bool = False) -> jnp.ndarray:
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (7, 7, 3, 64),
            self.param_dtype,
        ).astype(self.dtype)
        dn = ("NHWC", "HWIO", "NHWC")
        B, H, W, C = x.shape
        if not (s2d and H % 2 == 0 and W % 2 == 0):
            return jax.lax.conv_general_dilated(
                x, kernel, (2, 2), [(3, 3), (3, 3)], dimension_numbers=dn)
        w = jnp.pad(kernel, ((1, 0), (1, 0), (0, 0), (0, 0)))  # [8,8,3,64]
        w = w.reshape(4, 2, 4, 2, 3, 64).transpose(0, 2, 1, 3, 4, 5) \
            .reshape(4, 4, 4 * 3, 64)
        x2 = x.reshape(B, H // 2, 2, W // 2, 2, C) \
            .transpose(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        return jax.lax.conv_general_dilated(
            x2, w, (1, 1), [(2, 1), (2, 1)], dimension_numbers=dn)


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck with projection shortcut when needed."""

    filters: int  # inner width; output width = 4 * filters
    strides: int = 1
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = False):
        norm = lambda name: nn.BatchNorm(  # noqa: E731
            use_running_average=not train,
            momentum=0.9,
            epsilon=1e-5,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name=name,
        )
        conv = lambda f, k, s, name: nn.Conv(  # noqa: E731
            f,
            (k, k),
            strides=(s, s),
            padding=[(k // 2, k // 2)] * 2,
            use_bias=False,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name=name,
        )

        residual = x
        out = conv(self.filters, 1, 1, "conv1")(x)
        out = norm("bn1")(out)
        out = nn.relu(out)
        out = conv(self.filters, 3, self.strides, "conv2")(out)
        out = norm("bn2")(out)
        out = nn.relu(out)
        out = conv(self.filters * 4, 1, 1, "conv3")(out)
        out = norm("bn3")(out)

        if residual.shape[-1] != self.filters * 4 or self.strides != 1:
            residual = conv(self.filters * 4, 1, self.strides, "downsample_conv")(x)
            residual = norm("downsample_bn")(residual)

        return nn.relu(out + residual)


class ResNet50Encoder(nn.Module):
    """ResNet-50 feature extractor: [B,H,W,3] → 2048-d pooled features.

    Returns (pooled, features) where features maps stage names to NHWC
    feature maps (stage4 is the Grad-CAM target layer — the reference's
    `layer4`, `src/cnn_encoder.py:186-198`).
    """

    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    widths: Sequence[int] = (64, 128, 256, 512)
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, x: jnp.ndarray, train: bool = False
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        x = x.astype(self.dtype)
        # s2d only at inference: the train path keeps the canonical conv
        # so gradients/optimizer state see the standard formulation
        x = _StemConv(dtype=self.dtype, param_dtype=self.param_dtype,
                      name="stem_conv")(x, s2d=not train)
        x = nn.BatchNorm(
            use_running_average=not train,
            momentum=0.9,
            epsilon=1e-5,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="stem_bn",
        )(x)
        x = nn.relu(x)
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])

        features: Dict[str, jnp.ndarray] = {}
        for i, (num_blocks, width) in enumerate(zip(self.stage_sizes, self.widths)):
            for b in range(num_blocks):
                strides = 2 if (b == 0 and i > 0) else 1
                x = BottleneckBlock(
                    filters=width,
                    strides=strides,
                    dtype=self.dtype,
                    param_dtype=self.param_dtype,
                    name=f"stage{i + 1}_block{b}",
                )(x, train=train)
            features[f"stage{i + 1}"] = x

        pooled = jnp.mean(x, axis=(1, 2))  # global average pool → [B, 2048]
        return pooled, features

    @staticmethod
    def num_stages() -> int:
        return 4

    @staticmethod
    def feature_dim() -> int:
        return 2048
