"""Offline pretrained-weight conversion: torch/HF → this framework.

The reference relies on network-downloaded pretrained weights
(torchvision ResNet50 IMAGENET1K_V2 `src/cnn_encoder.py:73-86`, HF
BioBERT `src/text_encoder.py:52-67`). This environment has no egress, so
conversion is an *offline tool*: given a torch state_dict file (or an HF
model directory) supplied by the user, produce this framework's param
pytree with exact numerics.

Layout rules:
- torch Conv2d weight [O, I, kH, kW] → [kH, kW, I, O] (HWIO)
- torch Linear weight [O, I] → Dense kernel [I, O]
- BatchNorm: weight/bias → scale/bias (params); running_mean/var →
  mean/var (batch_stats)
- HF BERT q/k/v Linears concat into the fused qkv DenseGeneral kernel
  [H, 3, heads, d]; attention.output.dense → DenseGeneral [heads, d, H]
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Tuple

import numpy as np

log = logging.getLogger(__name__)

Params = Dict[str, Any]


def _t(w) -> np.ndarray:
    import torch

    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def _conv(w) -> np.ndarray:
    return np.transpose(_t(w), (2, 3, 1, 0))  # OIHW → HWIO


def _linear(w) -> np.ndarray:
    return np.transpose(_t(w), (1, 0))  # [O, I] → [I, O]


# ---------------------------------------------------------------------------
# torchvision ResNet50 → ResNet50Encoder
# ---------------------------------------------------------------------------

_BLOCKS_PER_STAGE = (3, 4, 6, 3)


def convert_torchvision_resnet50(sd: Mapping[str, Any]
                                 ) -> Tuple[Params, Params]:
    """torchvision resnet50 state_dict → (params, batch_stats) for
    ResNet50Encoder (fc layer ignored — the reference replaces it with
    Identity, `src/cnn_encoder.py:79`)."""
    params: Params = {}
    stats: Params = {}

    def put_bn(dst: str, src: str):
        params[dst] = {"scale": _t(sd[f"{src}.weight"]),
                       "bias": _t(sd[f"{src}.bias"])}
        stats[dst] = {"mean": _t(sd[f"{src}.running_mean"]),
                      "var": _t(sd[f"{src}.running_var"])}

    params["stem_conv"] = {"kernel": _conv(sd["conv1.weight"])}
    put_bn("stem_bn", "bn1")

    for stage, nblocks in enumerate(_BLOCKS_PER_STAGE, start=1):
        for b in range(nblocks):
            src = f"layer{stage}.{b}"
            dst = f"stage{stage}_block{b}"
            blk_p: Params = {}
            blk_s: Params = {}
            for i in (1, 2, 3):
                blk_p[f"conv{i}"] = {"kernel": _conv(sd[f"{src}.conv{i}.weight"])}
                blk_p[f"bn{i}"] = {"scale": _t(sd[f"{src}.bn{i}.weight"]),
                                   "bias": _t(sd[f"{src}.bn{i}.bias"])}
                blk_s[f"bn{i}"] = {"mean": _t(sd[f"{src}.bn{i}.running_mean"]),
                                   "var": _t(sd[f"{src}.bn{i}.running_var"])}
            if f"{src}.downsample.0.weight" in sd:
                blk_p["downsample_conv"] = {
                    "kernel": _conv(sd[f"{src}.downsample.0.weight"])}
                blk_p["downsample_bn"] = {
                    "scale": _t(sd[f"{src}.downsample.1.weight"]),
                    "bias": _t(sd[f"{src}.downsample.1.bias"])}
                blk_s["downsample_bn"] = {
                    "mean": _t(sd[f"{src}.downsample.1.running_mean"]),
                    "var": _t(sd[f"{src}.downsample.1.running_var"])}
            params[dst] = blk_p
            stats[dst] = blk_s
    return params, stats


# ---------------------------------------------------------------------------
# torchvision EfficientNet-B0 → EfficientNetB0Encoder
# ---------------------------------------------------------------------------

_B0_STAGES = ((1, 1), (6, 2), (6, 2), (6, 3), (6, 3), (6, 4), (6, 1))
# (expand_ratio, num_repeats) per features.1..7 — torchvision
# efficientnet_b0 (IMAGENET1K_V1), ref `src/cnn_encoder.py:88-100`


def convert_torchvision_efficientnet_b0(sd: Mapping[str, Any]
                                        ) -> Tuple[Params, Params]:
    """torchvision efficientnet_b0 state_dict → (params, batch_stats) for
    EfficientNetB0Encoder (classifier head ignored — replaced by Identity
    in the reference, `src/cnn_encoder.py:97-100`).

    torchvision layout: features.0 = stem ConvNormActivation;
    features.s.b.block.* = MBConv sub-Sequential (expand / depthwise / SE
    fc1+fc2 / project — the expand stage is absent when expand_ratio=1);
    features.8 = 1280-wide head. Note torchvision's train-time
    StochasticDepth has no parameters and is identity at eval, so eval
    numerics convert exactly.
    """
    params: Params = {}
    stats: Params = {}

    def put_bn(dst_p: Params, dst_s: Params, name: str, src: str):
        dst_p[name] = {"scale": _t(sd[f"{src}.weight"]),
                       "bias": _t(sd[f"{src}.bias"])}
        dst_s[name] = {"mean": _t(sd[f"{src}.running_mean"]),
                       "var": _t(sd[f"{src}.running_var"])}

    params["stem_conv"] = {"kernel": _conv(sd["features.0.0.weight"])}
    put_bn(params, stats, "stem_bn", "features.0.1")

    for s, (expand, repeats) in enumerate(_B0_STAGES, start=1):
        for b in range(repeats):
            src = f"features.{s}.{b}.block"
            dst = f"stage{s}_block{b}"
            bp: Params = {}
            bs: Params = {}
            i = 0
            if expand != 1:
                bp["expand_conv"] = {"kernel": _conv(sd[f"{src}.{i}.0.weight"])}
                put_bn(bp, bs, "expand_bn", f"{src}.{i}.1")
                i += 1
            bp["dw_conv"] = {"kernel": _conv(sd[f"{src}.{i}.0.weight"])}
            put_bn(bp, bs, "dw_bn", f"{src}.{i}.1")
            i += 1
            bp["se"] = {
                "reduce": {"kernel": _conv(sd[f"{src}.{i}.fc1.weight"]),
                           "bias": _t(sd[f"{src}.{i}.fc1.bias"])},
                "expand": {"kernel": _conv(sd[f"{src}.{i}.fc2.weight"]),
                           "bias": _t(sd[f"{src}.{i}.fc2.bias"])},
            }
            i += 1
            bp["project_conv"] = {"kernel": _conv(sd[f"{src}.{i}.0.weight"])}
            put_bn(bp, bs, "project_bn", f"{src}.{i}.1")
            params[dst] = bp
            stats[dst] = bs

    params["head_conv"] = {"kernel": _conv(sd["features.8.0.weight"])}
    put_bn(params, stats, "head_bn", "features.8.1")
    return params, stats


# ---------------------------------------------------------------------------
# HF BERT → BertEncoder
# ---------------------------------------------------------------------------

def convert_hf_bert(sd: Mapping[str, Any], num_layers: int = 12,
                    num_heads: int = 12) -> Params:
    """HF BertModel state_dict → BertEncoder params (fused-qkv layout)."""
    def g(key: str) -> np.ndarray:
        for prefix in ("", "bert."):
            if prefix + key in sd:
                return _t(sd[prefix + key])
        raise KeyError(key)

    p: Params = {
        "word_embeddings": {"embedding": g("embeddings.word_embeddings.weight")},
        "position_embeddings": {
            "embedding": g("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {
            "embedding": g("embeddings.token_type_embeddings.weight")},
        "embeddings_ln": {"scale": g("embeddings.LayerNorm.weight"),
                          "bias": g("embeddings.LayerNorm.bias")},
        "pooler": {"kernel": _linear(g("pooler.dense.weight")),
                   "bias": g("pooler.dense.bias")},
    }

    for i in range(num_layers):
        src = f"encoder.layer.{i}"
        H = g(f"{src}.attention.self.query.weight").shape[1]
        d = H // num_heads

        qkv_kernel = np.stack(
            [_linear(g(f"{src}.attention.self.{n}.weight"))
             .reshape(H, num_heads, d) for n in ("query", "key", "value")],
            axis=1)  # [H, 3, heads, d]
        qkv_bias = np.stack(
            [g(f"{src}.attention.self.{n}.bias").reshape(num_heads, d)
             for n in ("query", "key", "value")], axis=0)  # [3, heads, d]

        out_kernel = _linear(g(f"{src}.attention.output.dense.weight")) \
            .reshape(num_heads, d, H)

        p[f"layer{i}"] = {
            "attention": {
                "qkv": {"kernel": qkv_kernel, "bias": qkv_bias},
                "output": {"kernel": out_kernel,
                           "bias": g(f"{src}.attention.output.dense.bias")},
            },
            "attention_ln": {
                "scale": g(f"{src}.attention.output.LayerNorm.weight"),
                "bias": g(f"{src}.attention.output.LayerNorm.bias")},
            "intermediate": {
                "kernel": _linear(g(f"{src}.intermediate.dense.weight")),
                "bias": g(f"{src}.intermediate.dense.bias")},
            "output": {"kernel": _linear(g(f"{src}.output.dense.weight")),
                       "bias": g(f"{src}.output.dense.bias")},
            "output_ln": {"scale": g(f"{src}.output.LayerNorm.weight"),
                          "bias": g(f"{src}.output.LayerNorm.bias")},
        }
    return p


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, Any]:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return obj


def convert_backbone_into(params: Params, batch_stats: Params,
                          backbone_params: Params, backbone_stats: Params,
                          scope: str = "cnn_encoder") -> Tuple[Params, Params]:
    """Graft converted backbone weights into a full model param tree."""
    import copy

    params = copy.deepcopy(params)
    batch_stats = copy.deepcopy(batch_stats)
    params[scope]["backbone"] = backbone_params
    batch_stats.setdefault(scope, {})["backbone"] = backbone_stats
    return params, batch_stats


def convert_bert_into(params: Params, bert_params: Params,
                      scope: str = "text_encoder") -> Params:
    import copy

    params = copy.deepcopy(params)
    params[scope]["bert"] = bert_params
    return params
