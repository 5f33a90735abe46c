"""Golden-regression tests: fixed-seed tiny-model forwards pinned to
stored values (SURVEY.md §4's golden-parity strategy, applied to our own
outputs since the reference ships no checkpoints). Catches silent
numerics drift from refactors. Tolerances are loose enough to survive
compiler updates but tight enough to catch real changes."""

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import GOLDEN_ROW0, golden_probs
from multimodal_rare_disease.config import resolve_config
from multimodal_rare_disease.ops.preprocess import (
    eval_preprocess,
    train_preprocess,
)


def test_golden_multimodal_forward():
    # The golden model, inputs and pinned row live in chip_smoke.py so
    # the GPU parity check compares against the same numbers.
    # pinned 2026-08-16; REPINNED 2026-08-17 after the intentional
    # HF-style BERT init change (models/bert.py). Rule: any commit that
    # intentionally changes numerics must repin goldens in the same
    # commit. atol 2e-3: CPU XLA fusion differs slightly (~4e-4) between
    # execution contexts; real numerics changes shift ~1e-2.
    probs0 = golden_probs()
    if not np.allclose(probs0, GOLDEN_ROW0, atol=2e-3):
        raise AssertionError(
            f"golden drift:\n got {probs0.tolist()}\n want "
            f"{GOLDEN_ROW0.tolist()}")


def test_golden_eval_preprocess():
    cfg = resolve_config()
    u8 = jnp.asarray(
        np.random.default_rng(1).integers(0, 256, (1, 256, 256, 3),
                                          dtype=np.uint8))
    out = np.asarray(eval_preprocess(u8, cfg))
    # pinned statistics of the deterministic resize_crop+normalize
    # (repinned 2026-08-16 when eval geometry became PIL-exact
    # Resize(234)+CenterCrop(224) with antialiasing)
    assert abs(float(out.mean()) - 0.22729) < 2e-3, float(out.mean())
    assert abs(float(out.std()) - 0.79366) < 2e-2, float(out.std())


def test_golden_train_preprocess_seeded():
    cfg = resolve_config()
    u8 = jnp.asarray(
        np.random.default_rng(2).integers(0, 256, (1, 256, 256, 3),
                                          dtype=np.uint8))
    out = np.asarray(train_preprocess(u8, jax.random.key(7), cfg))
    assert out.shape == (1, 224, 224, 3)
    # the invariant: deterministic across runs for the same (data, key)
    out2 = np.asarray(train_preprocess(u8, jax.random.key(7), cfg))
    np.testing.assert_array_equal(out, out2)
