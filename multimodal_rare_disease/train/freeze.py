"""Parameter freezing and per-component learning-rate multipliers.

The reference freezes modules by setting `requires_grad=False`
(`src/cnn_encoder.py:102-166`, `src/text_encoder.py:69-93`) and builds
per-component optimizer param groups with LR multipliers
(`src/train_multimodal.py:422-454`: CNN 0.1×, text 0.5×, fusion/head 1.0×).

Functionally here: two pytrees aligned with params —
- trainable mask (False → update forced to zero)
- LR multiplier (per-component scale applied to the final update)

computed from param *paths*, so they work for any of the three model modes.
"""

from __future__ import annotations

import re
from typing import Any, Tuple

import jax
import numpy as np

from multimodal_rare_disease.config import Config

_STAGE_RE = re.compile(r"stage(\d+)")
_LAYER_RE = re.compile(r"layer(\d+)$")
_EMBED_NAMES = (
    "word_embeddings", "position_embeddings", "token_type_embeddings",
    "embeddings_ln",
)


def _path_names(path) -> Tuple[str, ...]:
    names = []
    for p in path:
        if hasattr(p, "key"):
            names.append(str(p.key))
        elif hasattr(p, "name"):
            names.append(str(p.name))
        else:
            names.append(str(p))
    return tuple(names)


def _is_frozen(names: Tuple[str, ...], cfg: Config) -> bool:
    if "cnn_encoder" in names and "backbone" in names:
        if cfg.cnn_encoder.freeze_backbone:
            return True
        n = cfg.cnn_encoder.freeze_stages
        if n > 0:
            if "stem_conv" in names or "stem_bn" in names:
                return True
            for part in names:
                m = _STAGE_RE.match(part)
                if m and int(m.group(1)) <= n:
                    return True
    if "text_encoder" in names:
        if cfg.text_encoder.freeze_embeddings and any(
                e in names for e in _EMBED_NAMES):
            return True
        n = cfg.text_encoder.freeze_layers
        if n > 0:
            for part in names:
                m = _LAYER_RE.match(part)
                if m and int(m.group(1)) < n:
                    return True
    return False


def _component(names: Tuple[str, ...]) -> str:
    for comp in ("cnn_encoder", "text_encoder", "fusion", "head"):
        if comp in names:
            return comp
    return "other"


def trainable_mask(cfg: Config, params: Any) -> Any:
    """Pytree of bool: True where the param receives updates."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: not _is_frozen(_path_names(path), cfg), params
    )


def lr_multipliers(cfg: Config, params: Any) -> Any:
    """Pytree of float32 per-param LR scale (component multiplier)."""
    t = cfg.training
    mult = {
        "cnn_encoder": t.lr_mult_cnn,
        "text_encoder": t.lr_mult_text,
        "fusion": t.lr_mult_fusion,
        "head": t.lr_mult_classifier,
        "other": 1.0,
    }
    return jax.tree_util.tree_map_with_path(
        lambda path, _: np.float32(mult[_component(_path_names(path))]), params
    )


def count_params(params: Any, mask: Any = None) -> Tuple[int, int]:
    """(total, trainable) parameter counts."""
    total = sum(x.size for x in jax.tree_util.tree_leaves(params))
    if mask is None:
        return total, total
    trainable = sum(
        x.size
        for x, m in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(mask))
        if m
    )
    return total, trainable
