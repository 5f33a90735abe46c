"""Multimodal fusion strategies.

Re-designs of the reference's three fusion modules
(`src/fusion_model.py:14-421`):

- ConcatenationFusion: concat(512 image, 768 text) → MLP → hidden (ref :14-71)
- AttentionFusion: project both to hidden, bidirectional multi-head
  cross-modal attention, residual+LayerNorm, concat+MLP; returns the
  attention weights for visualization (ref :185-291)
- GatedFusion: sigmoid gate convexly mixing the projected modalities
  (ref :294-362)

Note on parity: the reference applies cross-attention to *pooled*
embeddings (length-1 sequences), so softmax over a single key makes every
attention weight exactly 1.0. We reproduce that contract, and also offer
the upgrade `attend_over_tokens=True` where the image embedding attends
over the full 128/256-token BERT sequence (masked), which gives the
attention maps actual content and stays one fused matmul chain.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
from multimodal_rare_disease import nn

from multimodal_rare_disease.config import FusionConfig

Dtype = Any


class CrossModalAttention(nn.Module):
    """Multi-head attention of a query embedding over key/value states.

    query: [B, Dq]; kv: [B, S, Dk] (S=1 for pooled parity mode).
    Returns (output [B, hidden], attention_weights [B, heads, 1, S]).
    """

    hidden_dim: int
    num_heads: int = 8
    dropout: float = 0.1
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, query, kv, kv_mask=None, train: bool = False):
        d = self.hidden_dim // self.num_heads
        assert self.hidden_dim % self.num_heads == 0
        if kv.ndim == 2:
            kv = kv[:, None, :]
        q = nn.DenseGeneral((self.num_heads, d), axis=-1, dtype=self.dtype,
                            param_dtype=self.param_dtype, name="query_proj")(query)
        k = nn.DenseGeneral((self.num_heads, d), axis=-1, dtype=self.dtype,
                            param_dtype=self.param_dtype, name="key_proj")(kv)
        v = nn.DenseGeneral((self.num_heads, d), axis=-1, dtype=self.dtype,
                            param_dtype=self.param_dtype, name="value_proj")(kv)

        # q: [B,h,d], k/v: [B,S,h,d] → scores [B,h,S]
        scores = jnp.einsum("bhd,bshd->bhs", q, k) / jnp.sqrt(d).astype(self.dtype)
        if kv_mask is not None:
            neg = jnp.asarray(-1e9, dtype=scores.dtype)
            scores = jnp.where(kv_mask[:, None, :] > 0, scores, neg)
        weights = nn.softmax(scores.astype(jnp.float32), axis=-1).astype(self.dtype)
        weights_dropped = nn.Dropout(rate=self.dropout)(
            weights, deterministic=not train)
        ctx = jnp.einsum("bhs,bshd->bhd", weights_dropped, v)
        out = nn.DenseGeneral(self.hidden_dim, axis=(-2, -1), dtype=self.dtype,
                              param_dtype=self.param_dtype, name="output_proj")(ctx)
        # [B, heads, 1, S] to match the reference's weight shape
        return out, weights[:, :, None, :]


class ConcatenationFusion(nn.Module):
    hidden_dim: int = 512
    dropout: float = 0.3
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, image_embedding, text_embedding, train: bool = False,
                 **_ignored) -> Tuple[jnp.ndarray, Dict]:
        combined = jnp.concatenate([image_embedding, text_embedding], axis=-1)
        x = nn.Dense(self.hidden_dim, dtype=self.dtype,
                     param_dtype=self.param_dtype, name="fuse1")(combined)
        x = nn.relu(x)
        x = nn.Dropout(rate=self.dropout)(x, deterministic=not train)
        x = nn.Dense(self.hidden_dim, dtype=self.dtype,
                     param_dtype=self.param_dtype, name="fuse2")(x)
        return x, {}


class AttentionFusion(nn.Module):
    hidden_dim: int = 512
    num_heads: int = 8
    dropout: float = 0.3
    use_residual: bool = True
    attend_over_tokens: bool = False
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        image_embedding: jnp.ndarray,            # [B, Di]
        text_embedding: jnp.ndarray,             # [B, Dt]
        text_tokens: Optional[jnp.ndarray] = None,   # [B, S, Dt]
        text_mask: Optional[jnp.ndarray] = None,     # [B, S]
        train: bool = False,
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        image_proj = nn.Dense(self.hidden_dim, dtype=self.dtype,
                              param_dtype=self.param_dtype,
                              name="image_proj")(image_embedding)
        text_proj = nn.Dense(self.hidden_dim, dtype=self.dtype,
                             param_dtype=self.param_dtype,
                             name="text_proj")(text_embedding)

        if self.attend_over_tokens and text_tokens is not None:
            text_kv = nn.Dense(self.hidden_dim, dtype=self.dtype,
                               param_dtype=self.param_dtype,
                               name="text_token_proj")(text_tokens)
            kv_mask = text_mask
        else:
            text_kv = text_proj
            kv_mask = None

        image_attended, i2t_w = CrossModalAttention(
            self.hidden_dim, self.num_heads, self.dropout,
            dtype=self.dtype, param_dtype=self.param_dtype,
            name="image_to_text_attention",
        )(image_proj, text_kv, kv_mask=kv_mask, train=train)
        text_attended, t2i_w = CrossModalAttention(
            self.hidden_dim, self.num_heads, self.dropout,
            dtype=self.dtype, param_dtype=self.param_dtype,
            name="text_to_image_attention",
        )(text_proj, image_proj, train=train)

        ln_i = nn.LayerNorm(dtype=self.dtype, param_dtype=self.param_dtype,
                            name="layer_norm_image")
        ln_t = nn.LayerNorm(dtype=self.dtype, param_dtype=self.param_dtype,
                            name="layer_norm_text")
        if self.use_residual:
            image_out = ln_i(image_proj + image_attended)
            text_out = ln_t(text_proj + text_attended)
        else:
            image_out = ln_i(image_attended)
            text_out = ln_t(text_attended)

        combined = jnp.concatenate([image_out, text_out], axis=-1)
        x = nn.Dense(self.hidden_dim, dtype=self.dtype,
                     param_dtype=self.param_dtype, name="fusion1")(combined)
        x = nn.relu(x)
        x = nn.Dropout(rate=self.dropout)(x, deterministic=not train)
        fused = nn.Dense(self.hidden_dim, dtype=self.dtype,
                         param_dtype=self.param_dtype, name="fusion2")(x)

        attention_info = {
            "image_to_text_attention": i2t_w,
            "text_to_image_attention": t2i_w,
        }
        return fused, attention_info


class GatedFusion(nn.Module):
    hidden_dim: int = 512
    dropout: float = 0.3
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, image_embedding, text_embedding, train: bool = False,
                 **_ignored) -> Tuple[jnp.ndarray, Dict]:
        image_proj = nn.Dense(self.hidden_dim, dtype=self.dtype,
                              param_dtype=self.param_dtype,
                              name="image_proj")(image_embedding)
        text_proj = nn.Dense(self.hidden_dim, dtype=self.dtype,
                             param_dtype=self.param_dtype,
                             name="text_proj")(text_embedding)
        combined = jnp.concatenate([image_proj, text_proj], axis=-1)
        gate = nn.Dense(self.hidden_dim, dtype=self.dtype,
                        param_dtype=self.param_dtype, name="gate")(combined)
        gate = nn.sigmoid(gate)
        fused = gate * image_proj + (1.0 - gate) * text_proj
        out = nn.Dense(self.hidden_dim, dtype=self.dtype,
                       param_dtype=self.param_dtype, name="output")(fused)
        out = nn.relu(out)
        out = nn.Dropout(rate=self.dropout)(out, deterministic=not train)
        return out, {"gate": gate}


def create_fusion_module(
    cfg: FusionConfig,
    dtype: Dtype = jnp.float32,
    param_dtype: Dtype = jnp.float32,
    attend_over_tokens: bool = False,
    name: str = None,
) -> nn.Module:
    """Factory, parity with `create_fusion_module` (`src/fusion_model.py:424`)."""
    if cfg.fusion_type == "concatenation":
        return ConcatenationFusion(hidden_dim=cfg.hidden_dim, dropout=cfg.dropout,
                                   dtype=dtype, param_dtype=param_dtype, name=name)
    if cfg.fusion_type == "attention":
        return AttentionFusion(
            hidden_dim=cfg.hidden_dim,
            num_heads=cfg.num_attention_heads,
            dropout=cfg.dropout,
            use_residual=cfg.use_residual,
            attend_over_tokens=attend_over_tokens,
            dtype=dtype, param_dtype=param_dtype, name=name,
        )
    if cfg.fusion_type == "gated":
        return GatedFusion(hidden_dim=cfg.hidden_dim, dropout=cfg.dropout,
                           dtype=dtype, param_dtype=param_dtype, name=name)
    raise ValueError(f"Unknown fusion_type: {cfg.fusion_type!r}")
