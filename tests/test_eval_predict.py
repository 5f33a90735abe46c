"""Evaluator + predictor integration over a tiny trained model."""

from pathlib import Path

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # one-epoch trainings: minutes on CPU

from multimodal_rare_disease.evaluation import Evaluator, compare_models
from multimodal_rare_disease.inference import load_predictor
from multimodal_rare_disease.train import Trainer
from multimodal_rare_disease.train.pipeline import DataPipeline

from tests.test_trainer import REF_IMAGES, small_cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One-epoch image_only training on the real corpus, shared by tests."""
    if not REF_IMAGES.is_dir():
        pytest.skip("reference corpus absent")
    workdir = tmp_path_factory.mktemp("ckpt")
    cfg = small_cfg()
    pipeline = DataPipeline(cfg, mode="image_only", image_dir=str(REF_IMAGES))
    trainer = Trainer(cfg, mode="image_only", pipeline=pipeline,
                      workdir=str(workdir))
    trainer.train(num_epochs=1)
    return cfg, trainer, pipeline, workdir


def test_evaluator_full_artifacts(trained, tmp_path):
    cfg, trainer, pipeline, _ = trained
    ev = Evaluator(cfg, trainer.model, trainer.state.params,
                   trainer.state.batch_stats, mode="image_only")
    collected = ev.collect_predictions(pipeline.val_batches())
    assert len(collected["labels"]) == len(pipeline.val_samples)
    assert collected["probabilities"].shape[1] == 10

    metrics = ev.save_results(collected, tmp_path)
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert "per_class" in metrics and len(metrics["per_class"]) == 10
    for f in ["image_only_metrics.json", "image_only_predictions.npz",
              "image_only_confusion_matrix.png", "image_only_roc_curves.png",
              "image_only_per_class_metrics.png",
              "image_only_classification_report.txt"]:
        assert (tmp_path / f).exists(), f

    npz = np.load(tmp_path / "image_only_predictions.npz")
    np.testing.assert_array_equal(npz["labels"], collected["labels"])

    table = compare_models({"image_only": metrics}, tmp_path)
    assert "image_only" in table
    assert (tmp_path / "model_comparison.json").exists()
    assert (tmp_path / "model_comparison.png").exists()


def test_predictor_json_contract(trained):
    cfg, trainer, pipeline, workdir = trained
    pred = load_predictor(workdir / "image_only_best")
    img_path = pipeline.val_samples[0].path
    result = pred.predict(image=img_path, top_k=5)

    assert set(result) == {"predictions", "top_prediction",
                           "all_probabilities"}
    assert len(result["predictions"]) == 5
    p0 = result["predictions"][0]
    assert set(p0) == {"syndrome", "class_id", "confidence",
                       "probability_percent"}
    assert result["top_prediction"] == p0
    assert len(result["all_probabilities"]) == 10
    total = sum(result["all_probabilities"].values())
    assert total == pytest.approx(1.0, abs=1e-3)
    # descending confidence
    confs = [p["confidence"] for p in result["predictions"]]
    assert confs == sorted(confs, reverse=True)

    report = pred.format_report(result, patient_id="T-1")
    assert "RARE DISEASE DIAGNOSIS REPORT" in report
    assert p0["syndrome"] in report


def test_predictor_batch_and_embeddings(trained):
    cfg, trainer, pipeline, workdir = trained
    pred = load_predictor(workdir / "image_only_best")
    paths = [s.path for s in pipeline.val_samples[:3]]
    results = pred.predict_batch(images=paths, top_k=3,
                                 return_embeddings=True)
    assert len(results) == 3
    for r in results:
        assert len(r["predictions"]) == 3
        assert "embeddings" in r and "image" in r["embeddings"]


def test_predictor_accepts_array_input(trained):
    cfg, trainer, pipeline, workdir = trained
    pred = load_predictor(workdir / "image_only_best")
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)
    result = pred.predict(image=arr, top_k=1)
    assert result["top_prediction"]["class_id"] in range(10)


def test_predictor_wrong_modality_raises(trained):
    cfg, trainer, pipeline, workdir = trained
    pred = load_predictor(workdir / "image_only_best")
    with pytest.raises(ValueError):
        pred.predict_batch(images=None, texts=["hello"])


def test_predictor_packed_path_engages_and_matches(monkeypatch):
    """The predictor must actually ENGAGE sequence packing on the
    shipped corpus shape (clinical descriptions, batch >= 8) and return
    the same JSON contract as the classic bucketed forward
    (inference/packing.py; unit numerics in tests/test_packing.py)."""
    import json

    import jax.numpy as jnp

    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.inference import packing as packing_mod
    from multimodal_rare_disease.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease.models import create_model
    from multimodal_rare_disease.ops.preprocess import eval_preprocess

    desc_path = Path("/root/reference/data/"
                     "syndrome_clinical_descriptions.json")
    if not desc_path.exists():
        pytest.skip("reference corpus absent")
    descs = json.loads(desc_path.read_text())
    texts = [v["clinical_description"] for v in descs.values()]
    texts = (texts * 4)[:40]

    cfg = resolve_config("default", {
        "data.image_size": 32,
        "data.max_text_length": 128,
        "text_encoder.num_layers": 1,
        "text_encoder.num_heads": 2,
        "text_encoder.hidden_size": 32,
        "text_encoder.intermediate_size": 64,
        "fusion.text_proj_dim": 32,
        "fusion.hidden_dim": 32,
        "fusion.num_attention_heads": 2,
        "cnn_encoder.embedding_dim": 32,
        "classifier.hidden_dims": (32,),
        "training.compute_dtype": "float32",
    })
    model = create_model(cfg, mode="multimodal", dtype=jnp.float32)
    rng = np.random.default_rng(0)
    img0 = jnp.asarray(rng.integers(0, 256, (1, 256, 256, 3),
                                    dtype=np.uint8))
    variables = model.init(jax.random.key(0),
                           eval_preprocess(img0, cfg, dtype=jnp.float32),
                           jnp.zeros((1, 8), jnp.int32),
                           jnp.ones((1, 8), jnp.int32), train=False)
    pred = MultimodalPredictor(cfg, variables["params"],
                               variables.get("batch_stats", {}),
                               mode="multimodal")

    images = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
              for _ in range(40)]

    packed_calls = []
    orig_pack = packing_mod.pack_texts
    monkeypatch.setattr(
        packing_mod, "pack_texts",
        lambda *a, **k: (packed_calls.append(1), orig_pack(*a, **k))[1])
    res_packed = pred.predict_batch(images, texts, top_k=3)
    assert packed_calls, "packed path did not engage on corpus-shaped batch"

    monkeypatch.setattr(packing_mod, "packing_wins",
                        lambda *a, **k: False)
    res_classic = pred.predict_batch(images, texts, top_k=3)

    assert len(res_packed) == len(res_classic) == 40
    for a, b in zip(res_packed, res_classic):
        assert (a["top_prediction"]["class_id"]
                == b["top_prediction"]["class_id"])
        for k, v in a["all_probabilities"].items():
            assert abs(v - b["all_probabilities"][k]) < 1e-4
