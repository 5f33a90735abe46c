from pathlib import Path

import numpy as np
import pytest

from multimodal_rare_disease.train.text_pipeline import (
    TextDataPipeline,
    fgdd_text_pipeline,
)

from tests.test_trainer import small_cfg

FGDD_DIR = Path("/root/reference/data/FGDD")


def _toy_corpus(n_per_class=30, num_classes=3):
    texts, labels = [], []
    words = {0: "microcephaly seizures hypotonia",
             1: "macrodontia triangular face",
             2: "synophrys hirsutism limb defects"}
    for c in range(num_classes):
        for i in range(n_per_class):
            texts.append(f"Patient {i} presents with: {words[c]}.")
            labels.append(c)
    return texts, labels


def test_text_pipeline_batches_and_split():
    cfg = small_cfg(**{"classifier.num_classes": 3,
                       "training.batch_size": 8})
    texts, labels = _toy_corpus()
    p = TextDataPipeline(cfg, texts, labels, class_names=["a", "b", "c"])
    assert len(p.train_idx) + len(p.val_idx) == 90
    assert set(np.asarray(p.labels)[p.val_idx]) == {0, 1, 2}

    batches = list(p.train_batches())
    assert len(batches) == p.steps_per_epoch
    b = batches[0]
    assert b["input_ids"].shape == (8, cfg.data.max_text_length)
    assert b["labels"].shape == (8,)

    vb = list(p.val_batches())
    total_valid = sum(int(x["valid"].sum()) for x in vb)
    assert total_valid == len(p.val_idx)


def test_text_pipeline_trains():
    import jax

    from multimodal_rare_disease.train import Trainer

    cfg = small_cfg(**{"classifier.num_classes": 3,
                       "training.batch_size": 8,
                       "training.learning_rate": 3e-3,
                       "training.scheduler": "constant",
                       "data.augmentation_factor": 2})
    texts, labels = _toy_corpus()
    p = TextDataPipeline(cfg, texts, labels)
    t = Trainer(cfg, mode="text_only", pipeline=p)
    result = t.train(num_epochs=3)
    losses = result["history"]["train_loss"]
    # perfectly separable toy corpus: loss must fall substantially
    assert losses[-1] < losses[0] * 0.8
    assert result["history"]["val_acc"][-1] > 0.5


@pytest.mark.skipif(not FGDD_DIR.exists(), reason="FGDD corpus absent")
def test_fgdd_pipeline_builds():
    cfg = small_cfg(**{"training.batch_size": 16})
    p = fgdd_text_pipeline(cfg, fgdd_dir=str(FGDD_DIR))
    assert len(p.class_names) == 10
    assert len(p.train_idx) > 100
    b = next(iter(p.train_batches()))
    assert b["input_ids"].shape[0] == 16
    assert (b["labels"] < 10).all()


def test_trainer_resume(tmp_path):
    import jax

    from multimodal_rare_disease.train import Trainer

    cfg = small_cfg(**{"classifier.num_classes": 3,
                       "training.batch_size": 8,
                       "training.scheduler": "constant"})
    texts, labels = _toy_corpus(n_per_class=12)
    p = TextDataPipeline(cfg, texts, labels)
    t1 = Trainer(cfg, mode="text_only", pipeline=p, workdir=str(tmp_path))
    t1.train(num_epochs=2)

    t2 = Trainer(cfg, mode="text_only", pipeline=p, workdir=str(tmp_path))
    t2.init_state()
    t2._build_steps()
    t2._compiled = True
    t2.load(tmp_path / "text_only_last")
    assert len(t2.history["train_loss"]) == 2
    # optimizer moments restored (adam mu must be non-zero after training)
    flat = jax.tree_util.tree_leaves(t2.state.opt_state)
    assert any(np.abs(np.asarray(x)).max() > 0 for x in flat
               if hasattr(x, "shape") and np.asarray(x).size > 1)
    result = t2.train(num_epochs=4)  # continues epochs 3..4
    assert len(result["history"]["train_loss"]) == 4
