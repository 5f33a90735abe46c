"""Checkpoint crash-recovery semantics (advisor r2: a crash between
save_checkpoint's two directory renames must not lose the checkpoint)."""

import os

import numpy as np
import pytest

from multimodal_rare_disease.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


def _params(val):
    return {"dense": {"kernel": np.full((2, 2), val, np.float32)}}


def test_save_load_roundtrip(tmp_path):
    path = tmp_path / "ckpt"
    save_checkpoint(path, _params(1.0), {}, step=3, meta={"mode": "m"})
    params, bs, meta = load_checkpoint(path)
    assert meta["step"] == 3 and meta["mode"] == "m"
    np.testing.assert_array_equal(params["dense"]["kernel"],
                                  _params(1.0)["dense"]["kernel"])


def test_load_falls_back_to_old_sibling(tmp_path):
    """Simulate a crash after os.replace(path, old) but before
    os.replace(tmp, path): `path` missing, data intact in `.old`."""
    path = tmp_path / "ckpt"
    save_checkpoint(path, _params(2.0), {}, step=7, meta={})
    os.replace(path, tmp_path / "ckpt.old")  # the crash window
    params, _, meta = load_checkpoint(path)
    assert meta["step"] == 7
    np.testing.assert_array_equal(params["dense"]["kernel"],
                                  _params(2.0)["dense"]["kernel"])


def test_load_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "nope")


def test_bf16_and_optimizer_state_roundtrip(tmp_path):
    """bfloat16 leaves keep their dtype through the .npz, and optimizer
    moments come back as leaves in tree order."""
    import jax
    import ml_dtypes
    import optax

    params = {"enc": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)
                      .astype(ml_dtypes.bfloat16)},
              "head": {"bias": np.ones(3, np.float32)}}
    opt = optax.adam(1e-3).init(params)
    save_checkpoint(tmp_path / "c", params, {"bn": {"mean": np.zeros(2)}},
                    step=1, opt_state=opt)
    got, bs, meta = load_checkpoint(tmp_path / "c")
    assert got["enc"]["kernel"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got["enc"]["kernel"],
                                  params["enc"]["kernel"])
    np.testing.assert_array_equal(bs["bn"]["mean"], np.zeros(2))
    leaves = jax.tree_util.tree_leaves(opt)
    assert len(meta["_opt_state"]) == len(leaves)
    for a, b in zip(meta["_opt_state"], leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
