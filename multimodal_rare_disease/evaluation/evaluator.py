"""Evaluation suite: metrics, plots, artifacts.

Capability parity with `src/evaluate.py` (`Evaluator`, `compare_models`)
and `evaluate_multimodal.py`:

- batched mode-switched prediction collection (ref :79-123) — here one
  jitted forward with on-device preprocessing and padded final batches
- accuracy, macro/weighted precision/recall/F1, per-class metrics,
  one-vs-rest ROC-AUC (ref :125-200) via sklearn
- normalized confusion-matrix heatmap, per-class ROC curves, per-class
  metric bars (ref :231-318, evaluate_multimodal.py:166-226)
- save_results: {mode}_metrics.json, classification report txt, PNGs, and
  {mode}_predictions.npz (preds/labels/probs — the exchange format the
  statistical validation consumes, ref :320-364)
- compare_models table + JSON + comparison bar plot (ref :367-437)

Unlike the reference's stored result (computed on augmented TRAINING
images, SURVEY.md appendix), evaluation here defaults to a held-out split.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_rare_disease.config import Config, SYNDROME_NAMES
from multimodal_rare_disease.ops.preprocess import eval_preprocess

log = logging.getLogger(__name__)


def _short_names(names: Iterable[str]) -> List[str]:
    out = []
    for n in names:
        n = n.replace(" Syndrome", "")
        out.append(n if len(n) <= 14 else n[:12] + "…")
    return out


class Evaluator:
    """Collect predictions from a jitted model forward and compute the full
    metric/artifact suite."""

    def __init__(self, cfg: Config, model, params, batch_stats,
                 mode: str = "multimodal",
                 class_names: Optional[List[str]] = None):
        self.cfg = cfg
        self.model = model
        self.mode = mode
        self.class_names = list(class_names or SYNDROME_NAMES)
        self.params = params
        self.batch_stats = batch_stats

        def forward(params, batch_stats, batch):
            images = None
            if mode != "text_only":
                images = eval_preprocess(batch["images"], cfg)
            if mode == "multimodal":
                args = (images, batch["input_ids"], batch["attention_mask"])
            elif mode == "image_only":
                args = (images,)
            else:
                args = (batch["input_ids"], batch["attention_mask"])
            out = self.model.apply({"params": params,
                                    "batch_stats": batch_stats}, *args,
                                   train=False)
            return out["probs"]

        self._forward = jax.jit(forward)

    # -- collection --------------------------------------------------------

    def collect_predictions(self, batches) -> Dict[str, np.ndarray]:
        """batches: iterable of dicts with 'labels', 'valid' and modality
        inputs → {predictions, labels, probabilities}."""
        all_probs, all_labels = [], []
        for batch in batches:
            probs = np.asarray(
                self._forward(self.params, self.batch_stats,
                              {k: jnp.asarray(v) for k, v in batch.items()
                               if k not in ("labels", "valid")}))
            valid = batch.get("valid", np.ones(len(probs), np.float32)) > 0
            all_probs.append(probs[valid])
            all_labels.append(np.asarray(batch["labels"])[valid])
        probs = np.concatenate(all_probs)
        labels = np.concatenate(all_labels)
        return {
            "predictions": probs.argmax(-1).astype(np.int64),
            "labels": labels.astype(np.int64),
            "probabilities": probs.astype(np.float32),
        }

    # -- metrics -----------------------------------------------------------

    def compute_metrics(self, collected: Dict[str, np.ndarray]) -> Dict:
        from sklearn import metrics as skm

        y, yhat = collected["labels"], collected["predictions"]
        probs = collected["probabilities"]
        num_classes = probs.shape[1]
        present = np.unique(y)

        result: Dict = {
            "accuracy": float(skm.accuracy_score(y, yhat)),
            "precision_macro": float(skm.precision_score(
                y, yhat, average="macro", zero_division=0)),
            "recall_macro": float(skm.recall_score(
                y, yhat, average="macro", zero_division=0)),
            "f1_macro": float(skm.f1_score(
                y, yhat, average="macro", zero_division=0)),
            "precision_weighted": float(skm.precision_score(
                y, yhat, average="weighted", zero_division=0)),
            "recall_weighted": float(skm.recall_score(
                y, yhat, average="weighted", zero_division=0)),
            "f1_weighted": float(skm.f1_score(
                y, yhat, average="weighted", zero_division=0)),
            "num_samples": int(len(y)),
        }

        per_class = {}
        p, r, f1, support = skm.precision_recall_fscore_support(
            y, yhat, labels=np.arange(num_classes), zero_division=0)
        for i, name in enumerate(self.class_names[:num_classes]):
            per_class[name] = {
                "precision": float(p[i]), "recall": float(r[i]),
                "f1": float(f1[i]), "support": int(support[i]),
            }
        result["per_class"] = per_class

        # OvR ROC-AUC (only over classes present in labels)
        try:
            if len(present) == num_classes:
                result["roc_auc_ovr"] = float(skm.roc_auc_score(
                    y, probs, multi_class="ovr", average="macro"))
            elif len(present) > 1:
                result["roc_auc_ovr"] = float(skm.roc_auc_score(
                    y, probs[:, present], multi_class="ovr", average="macro",
                    labels=present))
        except ValueError as e:  # degenerate label sets
            log.warning("roc_auc skipped: %s", e)

        result["confusion_matrix"] = skm.confusion_matrix(
            y, yhat, labels=np.arange(num_classes)).tolist()
        return result

    # -- plots -------------------------------------------------------------

    def plot_confusion_matrix(self, collected, path: str | Path,
                              normalize: bool = True) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
        from sklearn.metrics import confusion_matrix

        num_classes = collected["probabilities"].shape[1]
        cm = confusion_matrix(collected["labels"], collected["predictions"],
                              labels=np.arange(num_classes)).astype(np.float64)
        if normalize:
            rows = cm.sum(1, keepdims=True)
            cm = np.divide(cm, rows, out=np.zeros_like(cm), where=rows > 0)
        names = _short_names(self.class_names[:num_classes])
        fig, ax = plt.subplots(figsize=(10, 8))
        sns.heatmap(cm, annot=True, fmt=".2f" if normalize else ".0f",
                    cmap="Blues", xticklabels=names, yticklabels=names, ax=ax)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title(f"Confusion Matrix ({self.mode})")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    def plot_roc_curves(self, collected, path: str | Path) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.metrics import auc, roc_curve

        y = collected["labels"]
        probs = collected["probabilities"]
        num_classes = probs.shape[1]
        fig, ax = plt.subplots(figsize=(10, 8))
        for i in range(num_classes):
            mask_pos = (y == i)
            if mask_pos.sum() == 0 or mask_pos.all():
                continue
            fpr, tpr, _ = roc_curve(mask_pos.astype(int), probs[:, i])
            ax.plot(fpr, tpr,
                    label=f"{_short_names([self.class_names[i]])[0]} "
                          f"(AUC {auc(fpr, tpr):.2f})")
        ax.plot([0, 1], [0, 1], "k--", lw=0.8)
        ax.set_xlabel("False positive rate")
        ax.set_ylabel("True positive rate")
        ax.set_title(f"Per-class ROC ({self.mode})")
        ax.legend(fontsize=8, loc="lower right")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    def plot_per_class_metrics(self, metrics: Dict, path: str | Path) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        per_class = metrics["per_class"]
        names = _short_names(per_class.keys())
        x = np.arange(len(names))
        width = 0.27
        fig, ax = plt.subplots(figsize=(12, 5))
        for off, key in zip((-width, 0, width), ("precision", "recall", "f1")):
            ax.bar(x + off, [v[key] for v in per_class.values()], width,
                   label=key)
        ax.set_xticks(x)
        ax.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
        ax.set_ylim(0, 1.05)
        ax.legend()
        ax.set_title(f"Per-class metrics ({self.mode})")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    # -- artifacts ---------------------------------------------------------

    def save_results(self, collected: Dict[str, np.ndarray],
                     results_dir: Optional[str | Path] = None) -> Dict:
        """Write the full artifact set; returns the metrics dict."""
        results_dir = Path(results_dir or self.cfg.evaluation.results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        metrics = self.compute_metrics(collected)

        with open(results_dir / f"{self.mode}_metrics.json", "w",
                  encoding="utf-8") as f:
            json.dump(metrics, f, indent=2)

        from sklearn.metrics import classification_report

        report = classification_report(
            collected["labels"], collected["predictions"],
            labels=np.arange(collected["probabilities"].shape[1]),
            target_names=self.class_names, zero_division=0)
        (results_dir / f"{self.mode}_classification_report.txt").write_text(
            report, encoding="utf-8")

        np.savez(
            results_dir / f"{self.mode}_predictions.npz",
            predictions=collected["predictions"],
            labels=collected["labels"],
            probabilities=collected["probabilities"],
        )
        self.plot_confusion_matrix(
            collected, results_dir / f"{self.mode}_confusion_matrix.png")
        self.plot_roc_curves(collected,
                             results_dir / f"{self.mode}_roc_curves.png")
        self.plot_per_class_metrics(
            metrics, results_dir / f"{self.mode}_per_class_metrics.png")

        # legacy-schema artifact (exact format of the reference's
        # results/evaluation_results.json, written by evaluate_multimodal.py)
        legacy = {
            "accuracy": metrics["accuracy"],
            "macro_precision": metrics["precision_macro"],
            "macro_recall": metrics["recall_macro"],
            "macro_f1": metrics["f1_macro"],
            "total_samples": metrics["num_samples"],
            "per_class": metrics["per_class"],
        }
        with open(results_dir / "evaluation_results.json", "w",
                  encoding="utf-8") as f:
            json.dump(legacy, f, indent=2)
        return metrics


def compare_models(metrics_by_mode: Dict[str, Dict],
                   results_dir: Optional[str | Path] = None) -> str:
    """Comparison table + JSON + bar plot (ref :367-437, :440-496)."""
    keys = ["accuracy", "precision_macro", "recall_macro", "f1_macro"]
    header = f"{'model':<14}" + "".join(f"{k:<18}" for k in keys)
    lines = [header, "-" * len(header)]
    for mode, m in metrics_by_mode.items():
        lines.append(f"{mode:<14}" + "".join(f"{m.get(k, float('nan')):<18.4f}"
                                             for k in keys))
    table = "\n".join(lines)

    if results_dir is not None:
        results_dir = Path(results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        with open(results_dir / "model_comparison.json", "w",
                  encoding="utf-8") as f:
            json.dump(metrics_by_mode, f, indent=2)

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.arange(len(keys))
        width = 0.8 / max(1, len(metrics_by_mode))
        fig, ax = plt.subplots(figsize=(9, 5))
        for i, (mode, m) in enumerate(metrics_by_mode.items()):
            ax.bar(x + i * width, [m.get(k, 0) for k in keys], width,
                   label=mode)
        ax.set_xticks(x + width * (len(metrics_by_mode) - 1) / 2)
        ax.set_xticklabels(keys)
        ax.set_ylim(0, 1.05)
        ax.legend()
        ax.set_title("Model comparison")
        fig.tight_layout()
        fig.savefig(results_dir / "model_comparison.png", dpi=120)
        plt.close(fig)
    return table
