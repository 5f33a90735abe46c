"""Classification heads and assembled models.

Re-designs of `src/multimodal_classifier.py`:
- ClassificationHead: MLP over hidden_dims → num_classes with
  relu/gelu/leaky_relu + dropout (ref :16-83)
- MultimodalClassifier: cnn_encoder + text_encoder + fusion + head,
  forward returns {logits, probs, [embeddings], [attention_info]}
  (ref :131-177)
- ImageOnlyClassifier / TextOnlyClassifier unimodal baselines (ref
  :205-293)
- create_model factory (ref :296-339)

Grad-CAM support is functional: `logits_from_image_features` re-runs the
model tail from a captured conv feature map so `jax.vjp` can produce the
class-score gradient w.r.t. that map (replaces PyTorch hooks).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax.numpy as jnp
from multimodal_rare_disease import nn

from multimodal_rare_disease.config import Config
from multimodal_rare_disease.models.bert import create_text_encoder
from multimodal_rare_disease.models.cnn_encoder import create_cnn_encoder
from multimodal_rare_disease.models.fusion import create_fusion_module

Dtype = Any

_ACTIVATIONS = {
    "relu": nn.relu,
    "gelu": nn.gelu,
    "leaky_relu": lambda x: nn.leaky_relu(x, negative_slope=0.01),
}


class ClassificationHead(nn.Module):
    hidden_dims: tuple = (256, 128)
    num_classes: int = 10
    dropout: float = 0.5
    activation: str = "relu"
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        act = _ACTIVATIONS[self.activation]
        for i, h in enumerate(self.hidden_dims):
            x = nn.Dense(h, dtype=self.dtype, param_dtype=self.param_dtype,
                         name=f"hidden{i}")(x)
            x = act(x)
            x = nn.Dropout(rate=self.dropout)(x, deterministic=not train)
        logits = nn.Dense(self.num_classes, dtype=self.dtype,
                          param_dtype=self.param_dtype, name="logits")(x)
        return logits.astype(jnp.float32)


class MultimodalClassifier(nn.Module):
    """Full multimodal model. Inputs: images [B,H,W,3] float NHWC,
    input_ids/attention_mask [B,T] int32."""

    cfg: Config
    attend_over_tokens: bool = False
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        c = self.cfg
        self.cnn_encoder = create_cnn_encoder(
            c.cnn_encoder, dtype=self.dtype, param_dtype=self.param_dtype,
            name="cnn_encoder")
        self.text_encoder = create_text_encoder(
            c.text_encoder, dtype=self.dtype, param_dtype=self.param_dtype,
            name="text_encoder")
        self.fusion = create_fusion_module(
            c.fusion, dtype=self.dtype, param_dtype=self.param_dtype,
            attend_over_tokens=self.attend_over_tokens, name="fusion")
        self.head = ClassificationHead(
            hidden_dims=tuple(c.classifier.hidden_dims),
            num_classes=c.classifier.num_classes,
            dropout=c.classifier.dropout,
            activation=c.classifier.activation,
            dtype=self.dtype, param_dtype=self.param_dtype, name="head")

    def __call__(
        self,
        images: jnp.ndarray,
        input_ids: jnp.ndarray,
        attention_mask: jnp.ndarray,
        train: bool = False,
        return_embeddings: bool = False,
        return_attention: bool = False,
    ) -> Dict[str, Any]:
        image_emb = self.cnn_encoder(images, train=train)

        need_tokens = self.attend_over_tokens
        if need_tokens:
            text_emb, text_out = self.text_encoder(
                input_ids, attention_mask, train=train, output_hidden_states=True)
            text_tokens = text_out["last_hidden_state"]
        else:
            text_emb = self.text_encoder(input_ids, attention_mask, train=train)
            text_tokens = None

        fused, attention_info = self.fusion(
            image_emb, text_emb,
            text_tokens=text_tokens, text_mask=attention_mask, train=train)
        logits = self.head(fused, train=train)

        out: Dict[str, Any] = {
            "logits": logits,
            "probs": nn.softmax(logits, axis=-1),
        }
        if return_embeddings:
            out["image_embedding"] = image_emb
            out["text_embedding"] = text_emb
            out["fused_embedding"] = fused
        if return_attention:
            out["attention_info"] = attention_info
        return out

    def packed_forward(
        self,
        images: jnp.ndarray,          # [N, H, W, 3]
        input_ids: jnp.ndarray,       # [R, C] packed rows
        position_ids: jnp.ndarray,    # [R, C]
        segment_ids: jnp.ndarray,     # [R, C]
        query_positions: jnp.ndarray,  # [R, P]
        doc_row: jnp.ndarray,         # [N]
        doc_slot: jnp.ndarray,        # [N]
    ) -> Dict[str, Any]:
        """Inference forward over a sequence-packed text batch
        (inference/packing.py): several short documents share each text
        row, per-document embeddings are gathered back to [N, H] and the
        fusion/head run per document. Bit-identical to `__call__` with
        per-document padded rows (tests/test_packing.py); the reference
        pads every request to a fixed 128 tokens (`src/predict.py:111-118`).
        Not supported with attend_over_tokens (token-level fusion wants
        per-document token streams)."""
        image_emb = self.cnn_encoder(images, train=False)
        txt = self.text_encoder(
            input_ids, None, train=False,
            position_ids=position_ids, segment_ids=segment_ids,
            query_positions=query_positions)          # [R, P, 768]
        text_emb = txt[doc_row, doc_slot]             # [N, 768]
        fused, _ = self.fusion(image_emb, text_emb, train=False)
        logits = self.head(fused, train=False)
        return {"logits": logits, "probs": nn.softmax(logits, axis=-1)}

    def image_feature_maps(self, images: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """Conv feature maps for Grad-CAM (inference mode)."""
        _, features = self.cnn_encoder.backbone_features(images, train=False)
        return features

    def logits_from_image_features(
        self,
        feature_map: jnp.ndarray,
        input_ids: jnp.ndarray,
        attention_mask: jnp.ndarray,
    ) -> jnp.ndarray:
        """Model tail from a captured last-stage conv feature map.

        jax.vjp through this function yields d(logits)/d(feature_map) —
        the Grad-CAM gradient (functional replacement for the reference's
        backward hooks, notebooks/explainability.ipynb cell 3).
        """
        image_emb = self.cnn_encoder.embed_from_feature_map(feature_map, train=False)
        if self.attend_over_tokens:
            text_emb, text_out = self.text_encoder(
                input_ids, attention_mask, train=False, output_hidden_states=True)
            text_tokens = text_out["last_hidden_state"]
        else:
            text_emb = self.text_encoder(input_ids, attention_mask, train=False)
            text_tokens = None
        fused, _ = self.fusion(image_emb, text_emb,
                               text_tokens=text_tokens, text_mask=attention_mask,
                               train=False)
        return self.head(fused, train=False)

    def text_attentions(self, input_ids, attention_mask):
        """Per-layer BERT attention maps (ref `src/text_encoder.py:151-179`)."""
        _, out = self.text_encoder(input_ids, attention_mask, train=False,
                                   output_attentions=True)
        return out["attentions"]


class ImageOnlyClassifier(nn.Module):
    """Unimodal image baseline (ref `src/multimodal_classifier.py:205-246`)."""

    cfg: Config
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.cnn_encoder = create_cnn_encoder(
            self.cfg.cnn_encoder, dtype=self.dtype, param_dtype=self.param_dtype,
            name="cnn_encoder")
        self.head = ClassificationHead(
            hidden_dims=tuple(self.cfg.classifier.hidden_dims),
            num_classes=self.cfg.classifier.num_classes,
            dropout=self.cfg.classifier.dropout,
            activation=self.cfg.classifier.activation,
            dtype=self.dtype, param_dtype=self.param_dtype, name="head")

    def __call__(self, images, train: bool = False,
                 return_embeddings: bool = False) -> Dict[str, Any]:
        emb = self.cnn_encoder(images, train=train)
        logits = self.head(emb, train=train)
        out = {"logits": logits, "probs": nn.softmax(logits, axis=-1)}
        if return_embeddings:
            out["image_embedding"] = emb
        return out

    def image_feature_maps(self, images):
        _, features = self.cnn_encoder.backbone_features(images, train=False)
        return features

    def logits_from_image_features(self, feature_map):
        emb = self.cnn_encoder.embed_from_feature_map(feature_map, train=False)
        return self.head(emb, train=False)


class TextOnlyClassifier(nn.Module):
    """Unimodal text baseline (ref `src/multimodal_classifier.py:249-293`)."""

    cfg: Config
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.text_encoder = create_text_encoder(
            self.cfg.text_encoder, dtype=self.dtype, param_dtype=self.param_dtype,
            name="text_encoder")
        self.head = ClassificationHead(
            hidden_dims=tuple(self.cfg.classifier.hidden_dims),
            num_classes=self.cfg.classifier.num_classes,
            dropout=self.cfg.classifier.dropout,
            activation=self.cfg.classifier.activation,
            dtype=self.dtype, param_dtype=self.param_dtype, name="head")

    def __call__(self, input_ids, attention_mask, train: bool = False,
                 return_embeddings: bool = False) -> Dict[str, Any]:
        emb = self.text_encoder(input_ids, attention_mask, train=train)
        logits = self.head(emb, train=train)
        out = {"logits": logits, "probs": nn.softmax(logits, axis=-1)}
        if return_embeddings:
            out["text_embedding"] = emb
        return out


def create_model(
    cfg: Config,
    mode: str = "multimodal",
    dtype: Optional[Any] = None,
    param_dtype: Optional[Any] = None,
    attend_over_tokens: bool = False,
) -> nn.Module:
    """Factory over the three modes (ref `src/multimodal_classifier.py:296-339`)."""
    if dtype is None:
        dtype = jnp.dtype(cfg.training.compute_dtype)
    if param_dtype is None:
        param_dtype = jnp.dtype(cfg.training.param_dtype)
    if mode == "multimodal":
        return MultimodalClassifier(cfg=cfg, attend_over_tokens=attend_over_tokens,
                                    dtype=dtype, param_dtype=param_dtype)
    if mode == "image_only":
        return ImageOnlyClassifier(cfg=cfg, dtype=dtype, param_dtype=param_dtype)
    if mode == "text_only":
        return TextOnlyClassifier(cfg=cfg, dtype=dtype, param_dtype=param_dtype)
    raise ValueError(f"Unknown mode: {mode!r}")
