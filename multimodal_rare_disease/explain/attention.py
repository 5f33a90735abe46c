"""Attention-based explainability.

Parity with the reference notebook's text-attention and cross-modal
visualizations (notebooks/explainability.ipynb cells 5, 7):

- text_token_attention: per-token attention received from [CLS] in the
  last BERT layer, averaged over heads, special tokens filtered — the
  quantity the reference renders as token highlights
- cross_modal_attention_summary: the fusion module's image→text and
  text→image attention weights per head (with attend_over_tokens, the
  image→text map is over real tokens and is rendered against them)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_rare_disease.config import Config
from multimodal_rare_disease.data.tokenizer import (
    SPECIAL_TOKENS,
    BertWordPieceTokenizer,
)


def text_token_attention(
    cfg: Config,
    model,
    params,
    batch_stats,
    tokenizer: BertWordPieceTokenizer,
    text: str,
    layer: int = -1,
) -> List[Tuple[str, float]]:
    """→ [(token, weight)] for real tokens, weights = CLS-row attention in
    the chosen layer, head-averaged and renormalized."""
    T = cfg.data.max_text_length
    ids, mask, _ = tokenizer.encode(text, T)
    ids_j = jnp.asarray(ids)[None]
    mask_j = jnp.asarray(mask)[None]

    attns = model.apply({"params": params, "batch_stats": batch_stats},
                        ids_j, mask_j, method="text_attentions")
    a = np.asarray(attns[layer])[0]          # [heads, T, T]
    cls_row = a.mean(0)[0]                   # [T] attention from CLS

    tokens = tokenizer.convert_ids_to_tokens(ids)
    n = int(mask.sum())
    pairs = [(tok, float(w)) for tok, w in zip(tokens[:n], cls_row[:n])
             if tok not in SPECIAL_TOKENS]
    total = sum(w for _, w in pairs) or 1.0
    return [(t, w / total) for t, w in pairs]


def cross_modal_attention_summary(
    attention_info: Dict[str, jnp.ndarray],
    tokenizer: Optional[BertWordPieceTokenizer] = None,
    input_ids: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Normalize the fusion attention maps for visualization.

    Returns {image_to_text: [heads, S], text_to_image: [heads, S'],
    [tokens: list]} for the first batch element.
    """
    out: Dict[str, np.ndarray] = {}
    i2t = np.asarray(attention_info["image_to_text_attention"])[0]  # [h,1,S]
    t2i = np.asarray(attention_info["text_to_image_attention"])[0]
    out["image_to_text"] = i2t[:, 0, :]
    out["text_to_image"] = t2i[:, 0, :]
    if tokenizer is not None and input_ids is not None:
        ids = np.asarray(input_ids).reshape(-1)
        if out["image_to_text"].shape[-1] == len(ids):
            out["tokens"] = np.array(
                tokenizer.convert_ids_to_tokens(ids.tolist()))
    return out


def plot_text_attention(pairs: Sequence[Tuple[str, float]], path,
                        top_k: int = 25) -> None:
    """Horizontal bar chart of token attention weights."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pairs = sorted(pairs, key=lambda p: -p[1])[:top_k][::-1]
    toks = [p[0] for p in pairs]
    ws = [p[1] for p in pairs]
    fig, ax = plt.subplots(figsize=(7, max(3, 0.3 * len(pairs))))
    ax.barh(range(len(pairs)), ws)
    ax.set_yticks(range(len(pairs)))
    ax.set_yticklabels(toks, fontsize=8)
    ax.set_xlabel("CLS attention (normalized)")
    ax.set_title("Text token attention")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_cross_modal_attention(summary: Dict[str, np.ndarray], path) -> None:
    """Per-head bar charts of the fusion attention weights (ref cell 7)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    i2t = summary["image_to_text"]
    heads = i2t.shape[0]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].imshow(i2t, aspect="auto", cmap="viridis")
    axes[0].set_title("image → text attention")
    axes[0].set_ylabel("head")
    axes[0].set_xlabel("key position")
    axes[1].imshow(summary["text_to_image"], aspect="auto", cmap="viridis")
    axes[1].set_title("text → image attention")
    axes[1].set_xlabel("key position")
    del heads
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
