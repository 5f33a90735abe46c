"""Environment verification (parity: `verify_setup.py` 7-step check —
rewritten against the current API, unlike the reference's stale version
which imports removed symbols, SURVEY.md appendix)."""

from __future__ import annotations

import argparse
import traceback


from multimodal_rare_disease.cli._common import (
    add_platform_arg,
    configure_platform,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Verify framework setup")
    parser.add_argument("--full", action="store_true",
                        help="include a forward pass of the full-size model")
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    configure_platform(args.platform)

    steps = []

    def step(name):
        def deco(fn):
            steps.append((name, fn))
            return fn
        return deco

    @step("1. imports")
    def _imports():
        import jax
        import optax

        import multimodal_rare_disease as pkg

        return (f"jax {jax.__version__}, optax {optax.__version__}, "
                f"pkg {pkg.__version__}")

    @step("2. devices & mesh")
    def _devices():
        from multimodal_rare_disease.config import get_config
        from multimodal_rare_disease.parallel import (
            create_mesh,
            describe_devices,
        )

        # An unreachable accelerator is an error here, not a reason to
        # fall back to the CPU (pass --platform cpu to run without one).
        mesh = create_mesh(get_config())
        return f"{describe_devices()}, mesh {dict(mesh.shape)}"

    @step("3. config")
    def _config():
        from multimodal_rare_disease.config import resolve_config

        cfg = resolve_config("multimodal")
        assert cfg.data.max_text_length == cfg.text_encoder.max_length
        return (f"presets ok; image {cfg.data.image_size}px, "
                f"text {cfg.data.max_text_length} tokens, "
                f"{cfg.classifier.num_classes} classes")

    @step("4. image corpus")
    def _corpus():
        from multimodal_rare_disease.config import get_config, find_image_dir
        from multimodal_rare_disease.data.images import (
            class_counts,
            scan_image_corpus,
        )

        d = find_image_dir(get_config())
        if d is None:
            return "no corpus found (synthetic generator available)"
        samples = scan_image_corpus(d)
        counts = class_counts(samples)
        return f"{len(samples)} images in {d} ({counts.min()}-{counts.max()}/class)"

    @step("5. clinical text & tokenizer")
    def _text():
        from multimodal_rare_disease.config import get_config
        from multimodal_rare_disease.data import get_tokenizer
        from multimodal_rare_disease.data.clinical_text import (
            load_clinical_descriptions,
        )

        desc = load_clinical_descriptions(get_config())
        tok = get_tokenizer()
        ids, mask, _ = tok.encode(
            next(iter(desc.values()))["clinical_description"], 128)
        return (f"{len(desc)} syndromes, vocab {tok.vocab_size}, "
                f"{int(mask.sum())} tokens in first description")

    @step("6. model build")
    def _model():
        import jax
        import jax.numpy as jnp

        from multimodal_rare_disease.config import resolve_config
        from multimodal_rare_disease.models import create_model
        from multimodal_rare_disease.train.freeze import (
            count_params,
            trainable_mask,
        )

        if args.full:
            cfg = resolve_config("multimodal")
        else:
            cfg = resolve_config("multimodal", {
                "text_encoder.num_layers": 2,
                "text_encoder.hidden_size": 64,
                "text_encoder.num_heads": 2,
                "text_encoder.intermediate_size": 128,
                "fusion.text_proj_dim": 64,
                "data.image_size": 64,
                "data.max_text_length": 32,
                "text_encoder.max_length": 32,
            })
        model = create_model(cfg, mode="multimodal", dtype=jnp.float32)
        S, T = cfg.data.image_size, cfg.data.max_text_length
        variables = model.init(jax.random.key(0), jnp.zeros((1, S, S, 3)),
                               jnp.ones((1, T), jnp.int32),
                               jnp.ones((1, T), jnp.int32))
        total, trainable = count_params(
            variables["params"], trainable_mask(cfg, variables["params"]))
        return (f"multimodal model {total / 1e6:.1f}M params "
                f"({trainable / 1e6:.1f}M trainable, "
                f"{100 * trainable / total:.0f}%)")

    @step("7. forward pass")
    def _forward():
        import jax
        import jax.numpy as jnp
        import numpy as np

        from multimodal_rare_disease.config import resolve_config
        from multimodal_rare_disease.models import create_model
        from multimodal_rare_disease.ops import train_preprocess

        cfg = resolve_config("default", {
            "data.image_size": 64,
            "text_encoder.num_layers": 1,
            "text_encoder.hidden_size": 32,
            "text_encoder.num_heads": 2,
            "text_encoder.intermediate_size": 64,
        })
        model = create_model(cfg, mode="image_only", dtype=jnp.float32)
        u8 = jnp.zeros((2, 256, 256, 3), jnp.uint8)
        x = train_preprocess(u8, jax.random.key(0), cfg)
        variables = model.init(jax.random.key(1), x)
        out = jax.jit(lambda v, x: model.apply(v, x))(variables, x)
        assert np.isfinite(np.asarray(out["probs"])).all()
        return f"jitted forward ok, probs {out['probs'].shape}"

    failed = 0
    for name, fn in steps:
        try:
            msg = fn()
            print(f"  [OK]   {name}: {msg}")
        except Exception as e:  # noqa: BLE001
            failed += 1
            print(f"  [FAIL] {name}: {e}")
            traceback.print_exc()
    print()
    if failed:
        print(f"{failed}/{len(steps)} steps FAILED")
        return 1
    print(f"all {len(steps)} steps passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
