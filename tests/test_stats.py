import json

import numpy as np
import pytest

from multimodal_rare_disease.evaluation.stats import (
    bootstrap_confidence_interval,
    chi_square_test,
    compare_multimodal_vs_unimodal,
    hypothesis_conclusion,
    make_demo_predictions,
    mcnemar_test,
    run_statistical_validation,
)


def test_demo_predictions_hit_target_accuracies():
    preds, labels = make_demo_predictions(n=5000)
    assert abs((preds["multimodal"] == labels).mean() - 0.85) < 0.02
    assert abs((preds["image_only"] == labels).mean() - 0.75) < 0.02
    assert abs((preds["text_only"] == labels).mean() - 0.70) < 0.02


def test_chi_square_detects_difference():
    preds, labels = make_demo_predictions(n=2000)
    r = chi_square_test(preds["multimodal"], preds["text_only"], labels)
    assert r["accuracy_a"] > r["accuracy_b"]
    assert 0 <= r["p_value"] <= 1


def test_mcnemar_exact_vs_chi2_branches():
    labels = np.zeros(30, np.int64)
    a = labels.copy()
    b = labels.copy()
    b[:5] = 1  # 5 discordant → exact binomial
    r = mcnemar_test(a, b, labels)
    assert r["method"] == "exact"
    assert r["n_discordant"] == 5

    labels2 = np.zeros(500, np.int64)
    a2 = labels2.copy()
    b2 = labels2.copy()
    b2[:100] = 1  # 100 discordant → chi2
    r2 = mcnemar_test(a2, b2, labels2)
    assert r2["method"] == "chi2"
    assert r2["significant"]

    # identical models → p=1
    r3 = mcnemar_test(a, a, labels)
    assert r3["p_value"] == 1.0


def test_mcnemar_significant_on_demo():
    preds, labels = make_demo_predictions(n=2000)
    r = mcnemar_test(preds["multimodal"], preds["text_only"], labels)
    assert r["significant"]  # 85% vs 70% on n=2000 must be significant


def test_bootstrap_ci_contains_accuracy():
    preds, labels = make_demo_predictions(n=500)
    ci = bootstrap_confidence_interval(preds["multimodal"], labels, 300)
    assert ci["ci_lower"] <= ci["accuracy"] <= ci["ci_upper"]
    assert ci["ci_upper"] - ci["ci_lower"] < 0.15


def test_compare_and_conclusion():
    preds, labels = make_demo_predictions(n=1000)
    results = compare_multimodal_vs_unimodal(preds, labels, n_bootstrap=100)
    assert results["summary"]["best_model"] == "multimodal"
    assert "multimodal_vs_image_only" in results["pairwise"]
    text = hypothesis_conclusion(results)
    assert "REJECT H0" in text


def test_run_statistical_validation_roundtrip(tmp_path):
    preds, labels = make_demo_predictions(n=500)
    for mode, p in preds.items():
        np.savez(tmp_path / f"{mode}_predictions.npz", predictions=p,
                 labels=labels,
                 probabilities=np.zeros((len(labels), 10), np.float32))
    results = run_statistical_validation(tmp_path, n_bootstrap=50)
    assert results is not None
    saved = json.loads((tmp_path / "statistical_results.json").read_text())
    assert saved["summary"]["best_model"] == "multimodal"

    # graceful None when dumps are missing
    empty = tmp_path / "empty"
    empty.mkdir()
    assert run_statistical_validation(empty) is None
