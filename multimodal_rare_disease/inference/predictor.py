"""Inference pipeline with the reference's JSON contract.

Parity with `src/predict.py` (`MultimodalPredictor`, :26-305) and the
root image-only `predict.py`:

- checkpoint load (role dir or explicit path; config restored from the
  checkpoint meta so the model is rebuilt exactly)
- single predict(image, text, top_k) returning
  {predictions: [{syndrome, class_id, confidence, probability_percent}],
   top_prediction, all_probabilities, [embeddings]}
  (the JSON schema of `src/predict.py:159-188` / README.md:210-228)
- predict_batch over lists of (image, text)
- format_report clinical-text rendering (ref :271-305)

One jitted forward (normalize → encoders → fusion → head), fixed batch
shapes with padding, so single requests and batch-256 streaming share
the same compiled program per bucket.

Multi-chip serving: pass a `jax.sharding.Mesh` ('data', 'model') and the
same compiled buckets run SPMD — inputs batch-sharded over 'data', the
BERT tower Megatron-sharded over 'model' via `parallel/tp.py`'s specs
(everything else replicated). XLA's partitioner inserts the collectives;
the predict code is identical either way. Sharded-vs-single-device
agreement is pinned by tests/test_predict_sharded.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_rare_disease.config import Config, SYNDROME_NAMES
from multimodal_rare_disease.data.images import load_image_uint8
from multimodal_rare_disease.data.tokenizer import (
    BertWordPieceTokenizer,
    get_tokenizer,
)
from multimodal_rare_disease.models import create_model
from multimodal_rare_disease.ops.preprocess import eval_preprocess
from multimodal_rare_disease.utils.checkpoint import load_checkpoint

ImageLike = Union[str, Path, np.ndarray]

_BATCH_BUCKETS = (1, 8, 32, 256)
# Sequence-length buckets for the text tower. Attention masking makes
# real-token outputs bit-identical regardless of trailing pad count
# (pads get -inf scores -> exactly-0 probabilities), so serving a batch
# at the smallest bucket >= its longest text saves work: the shipped
# clinical descriptions tokenize to 75-95 tokens, and the reference pads
# every request to a fixed 128 (`src/predict.py:111-118`). Buckets are
# clipped to cfg.data.max_text_length, which stays the truncation bound.
# The bucket set (multiples of 128 plus 32 and 64) comes from the first
# design and has not been re-tuned on the GPU.
_LENGTH_BUCKETS = (32, 64, 128, 256)


class MultimodalPredictor:
    """Loads a trained model and serves the prediction JSON contract."""

    def __init__(
        self,
        cfg: Config,
        params: Any,
        batch_stats: Any,
        mode: str = "multimodal",
        tokenizer: Optional[BertWordPieceTokenizer] = None,
        class_names: Optional[Sequence[str]] = None,
        length_bucketing: bool = True,
        mesh: Optional["jax.sharding.Mesh"] = None,
    ):
        self.cfg = cfg
        self.mode = mode
        self.length_bucketing = length_bucketing
        self.mesh = mesh
        self._data_size = 1
        if mesh is not None:
            from multimodal_rare_disease.parallel.tp import (
                shard_train_state,
            )

            # TP placements for the BERT tower over ('model'); every
            # other leaf — CNN, fusion, head, batch_stats — replicates.
            params = shard_train_state(mesh, params)
            batch_stats = shard_train_state(mesh, batch_stats)
            self._data_size = int(mesh.shape.get("data", 1))
        self.params = params
        self.batch_stats = batch_stats
        self.class_names = list(class_names or SYNDROME_NAMES)
        self.model = create_model(cfg, mode=mode)
        self.tokenizer = tokenizer if mode == "image_only" else (
            tokenizer or get_tokenizer())

        def forward(params, batch_stats, images, input_ids, attention_mask,
                    return_embeddings):
            x = None
            if mode != "text_only":
                x = eval_preprocess(images, cfg)
            if mode == "multimodal":
                args = (x, input_ids, attention_mask)
            elif mode == "image_only":
                args = (x,)
            else:
                args = (input_ids, attention_mask)
            return self.model.apply(
                {"params": params, "batch_stats": batch_stats}, *args,
                train=False, return_embeddings=return_embeddings)

        self._forward = jax.jit(forward, static_argnums=(5,))

        def forward_packed(params, batch_stats, images, input_ids,
                           position_ids, segment_ids, query_positions,
                           doc_row, doc_slot):
            x = eval_preprocess(images, cfg)
            return self.model.apply(
                {"params": params, "batch_stats": batch_stats}, x,
                input_ids, position_ids, segment_ids, query_positions,
                doc_row, doc_slot, method="packed_forward")

        self._forward_packed = jax.jit(forward_packed)

    # -- input preparation -------------------------------------------------

    def _prep_images(self, images: Sequence[ImageLike], n: int) -> np.ndarray:
        from multimodal_rare_disease.train.pipeline import STAGING_SIZE

        arrs = []
        for im in images:
            if isinstance(im, (str, Path)):
                arrs.append(load_image_uint8(str(im), STAGING_SIZE))
            else:
                a = np.asarray(im)
                if a.dtype != np.uint8:
                    a = np.clip(a, 0, 255).astype(np.uint8)
                if a.shape[:2] != (STAGING_SIZE, STAGING_SIZE):
                    from PIL import Image

                    a = np.asarray(Image.fromarray(a).resize(
                        (STAGING_SIZE, STAGING_SIZE), Image.BILINEAR))
                arrs.append(a)
        while len(arrs) < n:
            arrs.append(np.zeros_like(arrs[0]))
        return np.stack(arrs)

    def _prep_texts(self, texts: Sequence[str], n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        T = self.cfg.data.max_text_length
        ids, mask, _ = self.tokenizer.encode_batch(list(texts), T)
        if self.length_bucketing:
            longest = int(mask.sum(axis=1).max())
            bucket = next((b for b in _LENGTH_BUCKETS
                           if longest <= b < T), T)
            ids, mask = ids[:, :bucket], mask[:, :bucket]
        if len(texts) < n:
            pad = n - len(texts)
            ids = np.concatenate([ids, np.tile(ids[-1:], (pad, 1))])
            mask = np.concatenate([mask, np.tile(mask[-1:], (pad, 1))])
        return ids, mask

    def _bucket(self, n: int) -> int:
        # batch-sharded serving needs buckets divisible by the data axis
        # (shards must be equal); bucket 1 is skipped on an 8-way mesh
        d = self._data_size
        for b in _BATCH_BUCKETS:
            if n <= b and b % d == 0:
                return b
        # No standard bucket both fits n and divides the data axis
        # (overflow batches, or axis sizes like 6 that divide no listed
        # bucket): round up to a multiple of lcm(8, d) — equal shards on
        # any axis, 8-aligned. Single-device overflow keeps the
        # 256-multiple granularity.
        import math

        step = _BATCH_BUCKETS[-1] if d == 1 else math.lcm(8, d)
        return -(-max(n, 1) // step) * step

    def _place(self, arr: np.ndarray) -> jax.Array:
        """Host array → device. On a mesh: leading-dim sharded over
        'data' when divisible (batch rows, packed text rows), else
        replicated — XLA's SPMD partitioner takes it from there."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec

        spec = (PartitionSpec("data")
                if arr.ndim >= 1 and arr.shape[0] % self._data_size == 0
                else PartitionSpec())
        return jax.device_put(jnp.asarray(arr),
                              NamedSharding(self.mesh, spec))

    # -- prediction --------------------------------------------------------

    def predict(self, image: Optional[ImageLike] = None,
                text: Optional[str] = None, top_k: int = 5,
                return_embeddings: bool = False) -> Dict[str, Any]:
        """Single-sample prediction returning the JSON contract."""
        out = self.predict_batch(
            [image] if image is not None else None,
            [text] if text is not None else None,
            top_k=top_k, return_embeddings=return_embeddings)
        return out[0]

    def predict_batch(self, images: Optional[Sequence[ImageLike]] = None,
                      texts: Optional[Sequence[str]] = None, top_k: int = 5,
                      return_embeddings: bool = False) -> List[Dict[str, Any]]:
        n = len(images) if images is not None else len(texts)
        B = self._bucket(n)
        from multimodal_rare_disease.train.pipeline import STAGING_SIZE

        if self.mode != "text_only":
            if images is None:
                raise ValueError(f"mode {self.mode} requires images")
            imgs = self._prep_images(images, B)
        else:
            imgs = np.zeros((B, 1, 1, 3), np.uint8)
        if self.mode != "image_only":
            if texts is None:
                raise ValueError(f"mode {self.mode} requires texts")
            ids, mask = self._prep_texts(texts, B)
        else:
            ids = np.zeros((B, 1), np.int32)
            mask = np.ones((B, 1), np.int32)

        out = None
        if (self.mode == "multimodal" and not return_embeddings
                and self.length_bucketing and B >= 8):
            # Sequence packing (inference/packing.py): several short
            # documents per 128-multiple text row — ~30% fewer tokens
            # through the BERT tower on the shipped corpus (75-95-token
            # descriptions vs the 128 bucket). Outputs match the classic
            # path up to f32 summation order; engaged only when the
            # packed token count beats the bucket by >15%.
            from multimodal_rare_disease.inference.packing import (
                pack_texts, packing_wins,
            )

            lens = mask.sum(axis=1)
            bucket = ids.shape[1]
            cap = max(256, -(-int(lens.max()) // 128) * 128)
            if packing_wins(lens, bucket, capacity=cap):
                pb = pack_texts(ids, mask, capacity=cap, row_multiple=8)
                # compile-cache-friendly shapes: rows to a multiple of
                # 32 (above 32), query slots to a power of two
                R = pb.input_ids.shape[0]
                R2 = R if R <= 32 else -(-R // 32) * 32
                P = pb.query_positions.shape[1]
                P2 = 1 << max(0, P - 1).bit_length()
                pad_r = R2 - R
                qpos = np.pad(pb.query_positions, ((0, pad_r),
                                                   (0, P2 - P)))
                out = self._forward_packed(
                    self.params, self.batch_stats, self._place(imgs),
                    self._place(np.pad(pb.input_ids, ((0, pad_r), (0, 0)))),
                    self._place(np.pad(pb.position_ids,
                                       ((0, pad_r), (0, 0)))),
                    self._place(np.pad(pb.segment_ids,
                                       ((0, pad_r), (0, 0)))),
                    self._place(qpos), self._place(pb.doc_row),
                    self._place(pb.doc_slot))
        if out is None:
            out = self._forward(self.params, self.batch_stats,
                                self._place(imgs), self._place(ids),
                                self._place(mask), return_embeddings)
        probs = np.asarray(out["probs"], np.float32)[:n]
        results = []
        for i in range(n):
            results.append(self._format_single(probs[i], top_k))
            if return_embeddings:
                emb = {}
                if "image_embedding" in out:
                    emb["image"] = np.asarray(out["image_embedding"])[i].tolist()
                if "text_embedding" in out:
                    emb["text"] = np.asarray(out["text_embedding"])[i].tolist()
                if "fused_embedding" in out:
                    emb["fused"] = np.asarray(out["fused_embedding"])[i].tolist()
                results[-1]["embeddings"] = emb
        return results

    def _format_single(self, probs: np.ndarray, top_k: int) -> Dict[str, Any]:
        order = np.argsort(probs)[::-1][:top_k]
        predictions = [
            {
                "syndrome": (self.class_names[i] if i < len(self.class_names)
                             else f"Class_{i}"),
                "class_id": int(i),
                "confidence": float(probs[i]),
                "probability_percent": float(probs[i] * 100.0),
            }
            for i in order
        ]
        return {
            "predictions": predictions,
            "top_prediction": predictions[0] if predictions else None,
            "all_probabilities": {
                (self.class_names[i] if i < len(self.class_names)
                 else f"Class_{i}"): float(probs[i])
                for i in range(len(probs))
            },
        }

    # -- reporting ---------------------------------------------------------

    def format_report(self, result: Dict[str, Any],
                      patient_id: str = "N/A") -> str:
        """Clinical-report text rendering (ref `src/predict.py:271-305`)."""
        top = result["top_prediction"]
        lines = [
            "=" * 64,
            "RARE DISEASE DIAGNOSIS REPORT",
            "=" * 64,
            f"Patient ID: {patient_id}",
            "",
            "TOP PREDICTION:",
            f"  {top['syndrome']}",
            f"  Confidence: {top['confidence']:.4f} "
            f"({top['probability_percent']:.1f}%)",
            "",
            "DIFFERENTIAL DIAGNOSIS:",
        ]
        for i, p in enumerate(result["predictions"], 1):
            bar = "#" * int(round(p["confidence"] * 40))
            lines.append(f"  {i}. {p['syndrome']:<36} "
                         f"{p['probability_percent']:5.1f}% {bar}")
        lines += ["", "NOTE: Automated screening output; requires "
                  "confirmation by a clinical geneticist.", "=" * 64]
        return "\n".join(lines)


def load_predictor(checkpoint_path: str | Path,
                   mode: Optional[str] = None,
                   cfg: Optional[Config] = None,
                   tokenizer: Optional[BertWordPieceTokenizer] = None,
                   mesh: Optional["jax.sharding.Mesh"] = None
                   ) -> MultimodalPredictor:
    """Build a predictor from a checkpoint dir (config restored from meta)."""
    params, batch_stats, meta = load_checkpoint(checkpoint_path)
    if cfg is None:
        if "config" in meta:
            cfg = Config.from_dict(meta["config"])
        else:
            from multimodal_rare_disease.config import resolve_config

            cfg = resolve_config()
    mode = mode or meta.get("mode", "multimodal")
    if tokenizer is None and meta.get("vocab"):
        tokenizer = BertWordPieceTokenizer(
            {t: i for i, t in enumerate(meta["vocab"])})
    params = jax.tree_util.tree_map(jnp.asarray, params)
    batch_stats = jax.tree_util.tree_map(jnp.asarray, batch_stats)
    return MultimodalPredictor(cfg, params, batch_stats, mode=mode,
                               tokenizer=tokenizer,
                               class_names=meta.get("class_names"),
                               mesh=mesh)
