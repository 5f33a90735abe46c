import json

from multimodal_rare_disease.config import (
    SYNDROME_NAMES,
    PREFIX_TO_SYNDROME,
    Config,
    resolve_config,
)


def test_syndrome_names_canonical():
    assert len(SYNDROME_NAMES) == 10
    assert SYNDROME_NAMES[0] == "Cornelia de Lange Syndrome"
    assert SYNDROME_NAMES[-1] == "22q11.2 Deletion Syndrome"
    assert len(set(SYNDROME_NAMES)) == 10


def test_prefix_map_covers_all_classes():
    assert set(PREFIX_TO_SYNDROME.values()) == set(SYNDROME_NAMES)


def test_default_config():
    cfg = resolve_config()
    assert cfg.data.image_size == 224
    assert cfg.data.max_text_length == 128
    assert cfg.classifier.num_classes == 10
    assert cfg.training.optimizer == "adamw"
    assert cfg.seed == 42


def test_multimodal_preset_no_drift():
    cfg = resolve_config("multimodal")
    # single-source: the preset updates both places that used to drift
    assert cfg.data.max_text_length == 256
    assert cfg.text_encoder.max_length == 256
    assert cfg.training.learning_rate == 2e-5
    assert cfg.training.lr_mult_cnn == 0.1
    assert cfg.training.best_metric == "val_acc"
    assert cfg.cnn_encoder.freeze_stages == 3
    assert cfg.text_encoder.freeze_layers == 6


def test_overrides_dotted_and_dunder():
    cfg = resolve_config("default", {"training.batch_size": 32}, data__image_size=160)
    assert cfg.training.batch_size == 32
    assert cfg.data.image_size == 160


def test_unknown_key_raises():
    import pytest

    with pytest.raises(KeyError):
        resolve_config("default", {"training.nope": 1})


def test_roundtrip_json():
    cfg = resolve_config("multimodal")
    d = json.loads(cfg.to_json())
    cfg2 = Config.from_dict(d)
    assert cfg2.training.learning_rate == cfg.training.learning_rate
    assert cfg2.data.max_text_length == 256
    assert tuple(cfg2.syndrome_names) == SYNDROME_NAMES


def test_config_immutable():
    import dataclasses
    import pytest

    cfg = resolve_config()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.seed = 1


def test_compilation_cache_default(monkeypatch):
    """CLIs point JAX at a persistent compilation cache (fresh-process
    cold starts would otherwise re-pay minutes of XLA compile per CLI
    invocation); without JAX_COMPILATION_CACHE_DIR it is <repo>/.jax_cache,
    a path .gitignore lists."""
    import jax

    from multimodal_rare_disease.cli._common import (
        enable_compilation_cache,
    )
    from multimodal_rare_disease.config import BASE_DIR

    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(
            BASE_DIR / ".jax_cache")
        assert ".jax_cache/" in (BASE_DIR / ".gitignore").read_text()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compilation_cache_from_env(tmp_path, monkeypatch):
    """An explicit JAX_COMPILATION_CACHE_DIR wins over the default."""
    import jax

    from multimodal_rare_disease.cli._common import (
        enable_compilation_cache,
    )

    prev = jax.config.jax_compilation_cache_dir
    try:
        target = str(tmp_path / "cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
        enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == target
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_config_from_dict_ignores_removed_fields():
    """Checkpoint metadata written before the fused-kernel switches and
    the CPU-fallback knob were removed must still load."""
    from multimodal_rare_disease.config import Config, resolve_config

    d = resolve_config("multimodal").to_dict()
    d["text_encoder"]["fused_ffn"] = True
    d["text_encoder"]["fused_attn_out"] = False
    d["mesh"]["allow_cpu_fallback"] = True
    cfg = Config.from_dict(d)
    assert cfg == resolve_config("multimodal")


def test_from_scratch_fullsize_preset_encodes_measured_recipe():
    """The scale-cliff recipe (docs/TRAINING.md: full 12x3072 stack
    descends only at lr=1e-5, needs >=150 epochs) must be one --preset
    flag away."""
    from multimodal_rare_disease.config import resolve_config

    cfg = resolve_config("from_scratch_fullsize")
    # full-size tower: BERT-base depth/width, NOT the 6-layer shrink
    assert cfg.text_encoder.num_layers == 12
    assert cfg.text_encoder.intermediate_size == 3072
    # the measured stability threshold and horizon
    assert cfg.training.learning_rate == 1e-5
    assert cfg.training.num_epochs >= 150
    assert cfg.training.warmup_epochs == 3
    assert cfg.training.early_stopping is False


def test_cli_preset_choices_track_registry():
    """Every PRESETS key must be accepted by the CLI --preset flag — a
    hardcoded choices list rejected from_scratch_fullsize when it landed
    (round-5 regression)."""
    import argparse

    from multimodal_rare_disease.cli._common import add_config_args
    from multimodal_rare_disease.config import PRESETS

    parser = argparse.ArgumentParser()
    add_config_args(parser)
    for name in PRESETS:
        args = parser.parse_args(["--preset", name])
        assert args.preset == name
