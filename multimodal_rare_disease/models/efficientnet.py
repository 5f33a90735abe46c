"""EfficientNet-B0 image backbone.

Equivalent role to the reference's torchvision EfficientNet-B0 option
(`src/cnn_encoder.py:88-100`, selected via backbone="efficientnet_b0").
NHWC, bf16-capable, squeeze-excitation MBConv blocks, swish activations.
The final feature map (features[-1] in torchvision; "stage7" here, plus
the 1280-wide "head" map) is exposed for Grad-CAM.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp
from multimodal_rare_disease import nn

Dtype = Any

# (expand_ratio, out_channels, num_repeats, stride, kernel)
_B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class SqueezeExcite(nn.Module):
    reduced: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        s = jnp.mean(x, axis=(1, 2), keepdims=True)
        s = nn.Conv(self.reduced, (1, 1), dtype=self.dtype, param_dtype=self.param_dtype, name="reduce")(s)
        s = nn.swish(s)
        s = nn.Conv(x.shape[-1], (1, 1), dtype=self.dtype, param_dtype=self.param_dtype, name="expand")(s)
        return x * nn.sigmoid(s)


class MBConvBlock(nn.Module):
    expand_ratio: int
    out_channels: int
    strides: int
    kernel: int
    se_ratio: float = 0.25
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = False):
        norm = lambda name: nn.BatchNorm(  # noqa: E731
            use_running_average=not train,
            momentum=0.9,
            epsilon=1e-3,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name=name,
        )
        in_ch = x.shape[-1]
        mid = in_ch * self.expand_ratio
        residual = x

        if self.expand_ratio != 1:
            x = nn.Conv(mid, (1, 1), use_bias=False, dtype=self.dtype,
                        param_dtype=self.param_dtype, name="expand_conv")(x)
            x = norm("expand_bn")(x)
            x = nn.swish(x)

        p = self.kernel // 2
        x = nn.Conv(
            mid,
            (self.kernel, self.kernel),
            strides=(self.strides, self.strides),
            padding=[(p, p), (p, p)],
            feature_group_count=mid,
            use_bias=False,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="dw_conv",
        )(x)
        x = norm("dw_bn")(x)
        x = nn.swish(x)

        x = SqueezeExcite(
            reduced=max(1, int(in_ch * self.se_ratio)),
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="se",
        )(x)

        x = nn.Conv(self.out_channels, (1, 1), use_bias=False, dtype=self.dtype,
                    param_dtype=self.param_dtype, name="project_conv")(x)
        x = norm("project_bn")(x)

        if self.strides == 1 and in_ch == self.out_channels:
            x = x + residual
        return x


class EfficientNetB0Encoder(nn.Module):
    """EfficientNet-B0: [B,H,W,3] → 1280-d pooled features + feature maps."""

    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, x: jnp.ndarray, train: bool = False
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        norm = lambda name: nn.BatchNorm(  # noqa: E731
            use_running_average=not train,
            momentum=0.9,
            epsilon=1e-3,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name=name,
        )
        x = x.astype(self.dtype)
        x = nn.Conv(32, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)],
                    use_bias=False, dtype=self.dtype, param_dtype=self.param_dtype,
                    name="stem_conv")(x)
        x = norm("stem_bn")(x)
        x = nn.swish(x)

        features: Dict[str, jnp.ndarray] = {}
        for i, (expand, out_ch, repeats, stride, kernel) in enumerate(_B0_BLOCKS):
            for r in range(repeats):
                x = MBConvBlock(
                    expand_ratio=expand,
                    out_channels=out_ch,
                    strides=stride if r == 0 else 1,
                    kernel=kernel,
                    dtype=self.dtype,
                    param_dtype=self.param_dtype,
                    name=f"stage{i + 1}_block{r}",
                )(x, train=train)
            features[f"stage{i + 1}"] = x

        x = nn.Conv(1280, (1, 1), use_bias=False, dtype=self.dtype,
                    param_dtype=self.param_dtype, name="head_conv")(x)
        x = norm("head_bn")(x)
        x = nn.swish(x)
        features["head"] = x

        pooled = jnp.mean(x, axis=(1, 2))  # [B, 1280]
        return pooled, features

    @staticmethod
    def num_stages() -> int:
        return 7

    @staticmethod
    def feature_dim() -> int:
        return 1280
