"""Grad-CAM, functionally (no hooks).

Capability parity with the reference's `GradCAM` class
(notebooks/explainability.ipynb cell 3, backed by
`src/cnn_encoder.py:186-242` forward/backward hooks): class-activation
heatmaps over the last conv stage of the image encoder.

Functional formulation: the conv backbone runs once to capture the
last-stage feature map A; the model *tail* (pool → projection → [fusion]
→ head) is re-run as a pure function of A, and `jax.vjp` gives
dscore/dA in the same jitted program. Weights α = GAP(dscore/dA);
CAM = ReLU(Σ_c α_c · A_c), normalized — identical math to the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_rare_disease.config import Config
from multimodal_rare_disease.ops.preprocess import eval_preprocess


class GradCAM:
    """Grad-CAM for ImageOnlyClassifier / MultimodalClassifier."""

    def __init__(self, cfg: Config, model, params, batch_stats,
                 mode: str = "image_only"):
        self.cfg = cfg
        self.model = model
        self.mode = mode
        self.params = params
        self.batch_stats = batch_stats

        def compute(params, batch_stats, images_u8, input_ids, attention_mask,
                    class_idx, use_argmax):
            variables = {"params": params, "batch_stats": batch_stats}
            x = eval_preprocess(images_u8, cfg)
            feats = self.model.apply(variables, x,
                                     method="image_feature_maps")
            layer = (cfg.explainability.gradcam_layer
                     if cfg.explainability.gradcam_layer in feats
                     else sorted(feats)[-1])
            fmap = feats[layer]  # [B, h, w, C]

            if mode == "multimodal":
                def tail(fm):
                    return self.model.apply(
                        variables, fm, input_ids, attention_mask,
                        method="logits_from_image_features")
            else:
                def tail(fm):
                    return self.model.apply(
                        variables, fm, method="logits_from_image_features")

            logits, vjp = jax.vjp(tail, fmap)
            # single pass: the CAM class defaults to the argmax computed
            # from the same forward (no separate prediction run)
            target = jnp.argmax(logits, axis=-1) if use_argmax else class_idx
            onehot = jax.nn.one_hot(target, logits.shape[-1],
                                    dtype=logits.dtype)
            (grad,) = vjp(onehot)  # dscore/dA [B, h, w, C]

            alpha = jnp.mean(grad, axis=(1, 2), keepdims=True)  # GAP weights
            cam = jnp.maximum(jnp.sum(alpha * fmap, axis=-1), 0.0)  # [B,h,w]
            cam_min = jnp.min(cam, axis=(1, 2), keepdims=True)
            cam_max = jnp.max(cam, axis=(1, 2), keepdims=True)
            cam = (cam - cam_min) / jnp.maximum(cam_max - cam_min, 1e-8)
            return cam, logits

        self._compute = jax.jit(compute, static_argnames=("use_argmax",))

    def __call__(self, images_u8: np.ndarray,
                 input_ids: Optional[np.ndarray] = None,
                 attention_mask: Optional[np.ndarray] = None,
                 class_idx: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (cam [B, h, w] in [0,1], logits [B, K]). class_idx defaults to
        the predicted class (argmax)."""
        images_u8 = jnp.asarray(images_u8)
        B = images_u8.shape[0]
        if input_ids is None:
            input_ids = jnp.zeros((B, 1), jnp.int32)
            attention_mask = jnp.ones((B, 1), jnp.int32)
        use_argmax = class_idx is None
        if use_argmax:
            class_idx = jnp.zeros((B,), jnp.int32)  # ignored
        cam, logits = self._compute(self.params, self.batch_stats, images_u8,
                                    jnp.asarray(input_ids),
                                    jnp.asarray(attention_mask),
                                    jnp.asarray(class_idx),
                                    use_argmax=use_argmax)
        return np.asarray(cam), np.asarray(logits)


def gradcam_heatmap(cam: np.ndarray, out_size: int = 224) -> np.ndarray:
    """Upsample a [h, w] CAM to [out_size, out_size] (bilinear, numpy)."""
    from PIL import Image

    im = Image.fromarray((np.asarray(cam) * 255).astype(np.uint8))
    return np.asarray(im.resize((out_size, out_size), Image.BILINEAR),
                      np.float32) / 255.0


def overlay_heatmap(image_u8: np.ndarray, cam: np.ndarray,
                    alpha: float = 0.45) -> np.ndarray:
    """Blend a CAM over an RGB uint8 image using a jet-like colormap."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm

    H, W = image_u8.shape[:2]
    heat = gradcam_heatmap(cam, H) if cam.shape[:2] != (H, W) else cam
    colored = cm.jet(heat)[..., :3]  # [H, W, 3] float
    out = (1 - alpha) * (image_u8.astype(np.float32) / 255.0) + alpha * colored
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
