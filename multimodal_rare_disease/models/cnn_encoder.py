"""CNN image encoder: backbone + projection head.

Capability-equivalent to the reference's `CNNEncoder`
(`src/cnn_encoder.py:27-242`): a ResNet50 or EfficientNet-B0 backbone
followed by a 2-layer MLP projection (feature_dim → embed → embed with
ReLU + dropout, ref `:46-51`), exposing the last conv stage for Grad-CAM
and intermediate stage features. Freezing (`freeze_backbone` /
`freeze_stages`) is enforced by the optimizer's trainability mask — see
`train/freeze.py` — not by mutating the module.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp
from multimodal_rare_disease import nn

from multimodal_rare_disease.config import CNNEncoderConfig
from multimodal_rare_disease.models.efficientnet import EfficientNetB0Encoder
from multimodal_rare_disease.models.resnet import ResNet50Encoder

Dtype = Any


class CNNEncoder(nn.Module):
    backbone: str = "resnet50"
    embedding_dim: int = 512
    dropout: float = 0.5
    # blocks per ResNet stage; None = canonical (3, 4, 6, 3). Smaller
    # towers keep the 4-stage topology (freeze/Grad-CAM semantics) at a
    # fraction of the compile cost. EfficientNet ignores it.
    stage_sizes: Any = None
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        if self.backbone == "resnet50":
            kw = {}
            if self.stage_sizes is not None:
                kw["stage_sizes"] = tuple(self.stage_sizes)
            self.encoder = ResNet50Encoder(
                dtype=self.dtype, param_dtype=self.param_dtype,
                name="backbone", **kw
            )
        elif self.backbone in ("efficientnet_b0", "efficientnet-b0"):
            self.encoder = EfficientNetB0Encoder(
                dtype=self.dtype, param_dtype=self.param_dtype, name="backbone"
            )
        else:
            raise ValueError(f"Unknown backbone: {self.backbone!r}")
        self.proj1 = nn.Dense(self.embedding_dim, dtype=self.dtype,
                              param_dtype=self.param_dtype, name="proj1")
        self.proj2 = nn.Dense(self.embedding_dim, dtype=self.dtype,
                              param_dtype=self.param_dtype, name="proj2")
        self.drop = nn.Dropout(rate=self.dropout)

    def __call__(
        self,
        images: jnp.ndarray,
        train: bool = False,
        return_features: bool = False,
    ):
        """[B,H,W,3] float images → [B, embedding_dim] (+ feature maps)."""
        pooled, features = self.encoder(images, train=train)
        emb = self.project(pooled, train=train)
        if return_features:
            return emb, features
        return emb

    def project(self, pooled: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        x = self.proj1(pooled)
        x = nn.relu(x)
        x = self.drop(x, deterministic=not train)
        x = self.proj2(x)
        return x

    def backbone_features(self, images: jnp.ndarray, train: bool = False):
        """Run only the conv backbone; returns (pooled, feature maps).

        Functional replacement for the reference's forward/backward hook
        capture (`src/cnn_encoder.py:186-242`): Grad-CAM takes
        `jax.vjp` through `embed_from_feature_map` instead.
        """
        return self.encoder(images, train=train)

    def embed_from_feature_map(self, feature_map: jnp.ndarray, train: bool = False):
        """Last-stage feature map [B,h,w,C] → embedding (pool + projection)."""
        pooled = jnp.mean(feature_map, axis=(1, 2))
        return self.project(pooled, train=train)

    @property
    def gradcam_layer(self) -> str:
        return "stage4" if self.backbone == "resnet50" else "head"

    @property
    def num_stages(self) -> int:
        return 4 if self.backbone == "resnet50" else 7


def create_cnn_encoder(
    cfg: CNNEncoderConfig,
    dtype: Dtype = jnp.float32,
    param_dtype: Dtype = jnp.float32,
    name: str = None,
) -> CNNEncoder:
    """Factory, parity with `create_cnn_encoder` (`src/cnn_encoder.py:285`)."""
    return CNNEncoder(
        backbone=cfg.backbone,
        embedding_dim=cfg.embedding_dim,
        dropout=cfg.dropout,
        stage_sizes=cfg.stage_sizes,
        dtype=dtype,
        param_dtype=param_dtype,
        name=name,
    )
