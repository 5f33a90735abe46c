from pathlib import Path

import numpy as np
import pytest

from multimodal_rare_disease.train import Trainer
from multimodal_rare_disease.train.pipeline import DataPipeline

from tests.test_trainer import REF_IMAGES, small_cfg


@pytest.mark.slow
@pytest.mark.skipif(not REF_IMAGES.is_dir(), reason="reference corpus absent")
def test_trainer_with_mixup_runs():
    cfg = small_cfg(**{"data.mixup_alpha": 0.4})
    pipeline = DataPipeline(cfg, mode="image_only", image_dir=str(REF_IMAGES))
    trainer = Trainer(cfg, mode="image_only", pipeline=pipeline,
                      workdir="/tmp/mixup_test_ckpt")
    result = trainer.train(num_epochs=1)
    assert np.isfinite(result["history"]["train_loss"][0])
    assert result["skipped_steps"] == 0
