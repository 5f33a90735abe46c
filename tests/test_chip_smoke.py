"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to
run without a GPU. (On the GPU machine the script itself runs them at
full width.)"""

import jax
import numpy as np

import chip_smoke

TINY = {
    "data.image_size": 64,
    "data.max_text_length": 128,
    "text_encoder.max_length": 128,
    "text_encoder.num_layers": 1,
    "text_encoder.num_heads": 2,
    "text_encoder.hidden_size": 32,
    "text_encoder.intermediate_size": 64,
    "text_encoder.vocab_size": 4096,
    "fusion.text_proj_dim": 32,
    "fusion.hidden_dim": 32,
    "fusion.num_attention_heads": 2,
    "cnn_encoder.embedding_dim": 32,
    "cnn_encoder.stage_sizes": (1, 1, 1, 1),
    "classifier.hidden_dims": (32,),
}
TINY_TRAIN = {**TINY, "data.augmentation_factor": 1,
              "data.online_rotation": False,
              "text_encoder.freeze_layers": 0}


def _sc(predict_batch=16):
    return chip_smoke.SmokeConfig(overrides=TINY, train_overrides=TINY_TRAIN,
                                  predict_batch=predict_batch,
                                  images_per_class=2, serve_requests=3)


def _observations(out: str):
    return [line for line in out.splitlines()
            if line.startswith("bring-up observation:")]


def test_main_refuses_cpu(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out.out and "needs a GPU" in out.err


def test_predict_and_parity_phases(capsys):
    # packing engages only at batches large enough to fill its rows
    assert chip_smoke.run_phases(["predict", "parity"], _sc(256))
    lines = _observations(capsys.readouterr().out)
    assert len(lines) == 2 and all(" ok " in line for line in lines)
    assert "packed_vs_bucketed_max_abs=" in lines[0]
    assert "f32_default_vs_highest_max_abs=" in lines[1]


def test_train_and_serve_phases(capsys):
    assert chip_smoke.run_phases(["train", "serve"], _sc())
    lines = _observations(capsys.readouterr().out)
    assert [line.split()[2] for line in lines] == ["phase=train",
                                                  "phase=serve"]
    assert all(" ok " in line for line in lines)


def test_failed_phase_reports_and_fails(capsys, monkeypatch):
    def boom(ctx):
        raise RuntimeError("injected")

    monkeypatch.setattr(chip_smoke, "phase_predict", boom)
    assert not chip_smoke.run_phases(["predict"], _sc(), None)
    assert "phase=predict FAILED" in capsys.readouterr().out


def test_four_phase_on_virtual_devices(capsys):
    """DP 4x1 and DP x TP 2x2 train steps and the 2x2 sharded predict
    agree with one device (4 virtual CPU devices)."""
    devices = jax.devices()
    assert len(devices) >= 4
    assert chip_smoke.run_phases(["four"], _sc(), devices[:4])
    (line,) = _observations(capsys.readouterr().out)
    assert " ok " in line and "loss_2x2=" in line


def test_golden_check_passes_on_cpu():
    assert chip_smoke.check_golden() <= chip_smoke.GOLDEN_ATOL
    assert np.isfinite(chip_smoke.golden_probs()).all()


def test_bench_refuses_cpu(capsys):
    """bench.py prints no number without a GPU (no stale or CPU result)."""
    import bench

    assert bench.main([]) != 0
    assert capsys.readouterr().out == ""
