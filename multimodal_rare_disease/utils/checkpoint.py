"""Checkpoints with best/last roles: one `.npz` of arrays plus a JSON
sidecar.

Replaces the reference's `torch.save` dict checkpoints
(`src/train.py:394-437`, `src/train_multimodal.py:624-664`): the array
tree ({params, batch_stats, [opt_state]}) flattened to '/'-joined keys in
`arrays.npz`, plus `meta.json` carrying step, epoch, best metric,
training history and the resolved config — the same information
content, restorable without pickle.

Roles: `{mode}_best` / `{mode}_last` (ref files `{mode}_best.pt`,
`{mode}_last.pt`, `best_model.pt`, `multimodal_best.pt`).
`load_checkpoint` accepts either role dir or an explicit path.
"""

from __future__ import annotations

import json
import os
import shutil
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

_ARRAYS_FILE = "arrays.npz"
_META_FILE = "meta.json"
# npz stores only numpy's own dtypes: other float types (bfloat16) are
# written as their raw bits and their names listed under this key
_DTYPES_KEY = "__dtypes__"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"checkpoint key {k!r} contains '/'")
            _flatten(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray], top: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] != top:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_checkpoint(
    path: str | Path,
    params: Any,
    batch_stats: Any,
    step: int,
    meta: Optional[Dict[str, Any]] = None,
    opt_state: Any = None,
) -> None:
    """Write/overwrite a checkpoint directory. `opt_state` (optimizer
    moments) is included for resumable "last" checkpoints — parity with
    the reference's optimizer_state_dict (`src/train.py:394-422`); it is
    stored as its leaves in `jax.tree_util` order and restored into the
    optimizer's own structure by the trainer.

    Crash-safe: the new checkpoint is fully written to a sibling `.tmp`
    directory first, then swapped in via two renames. Directory swaps
    cannot be a single atomic rename, so a crash between the two
    renames can leave `path` briefly absent with the data intact in the
    `.old` sibling — `load_checkpoint` falls back to `.old` (and `.tmp`)
    in that case, so no committed checkpoint is ever lost."""
    path = Path(path).absolute()
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten(jax.device_get(params), "params", flat)
    _flatten(jax.device_get(batch_stats), "batch_stats", flat)
    if opt_state is not None:
        for i, leaf in enumerate(jax.tree_util.tree_leaves(
                jax.device_get(opt_state))):
            flat[f"opt_state/{i:06d}"] = np.asarray(leaf)
    dtypes = []
    for key, arr in flat.items():
        if arr.dtype.type.__module__ != "numpy":
            dtypes.append(f"{key}={arr.dtype.name}")
            flat[key] = arr.view(f"u{arr.dtype.itemsize}")
    flat[_DTYPES_KEY] = np.asarray(dtypes, dtype=str)
    with open(tmp / _ARRAYS_FILE, "wb") as f:
        np.savez(f, **flat)
    with open(tmp / _META_FILE, "w", encoding="utf-8") as f:
        json.dump({"step": int(step), **(meta or {})}, f, indent=2, default=str)
    if path.exists():
        old = path.with_name(path.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)


def load_checkpoint(path: str | Path) -> Tuple[Any, Any, Dict[str, Any]]:
    """→ (params, batch_stats, meta).

    If `path` is missing but a `.old` / `.tmp` sibling holds a complete
    checkpoint (a crash landed between save_checkpoint's two directory
    renames), recover from the sibling."""
    path = Path(path).absolute()
    if not (path / _ARRAYS_FILE).exists():
        for suffix in (".old", ".tmp"):
            sib = path.with_name(path.name + suffix)
            if (sib / _ARRAYS_FILE).exists() and (sib / _META_FILE).exists():
                path = sib
                break
        else:
            raise FileNotFoundError(f"no checkpoint at {path}")
    import ml_dtypes

    with np.load(path / _ARRAYS_FILE, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    for entry in flat.pop(_DTYPES_KEY, np.asarray([], str)).tolist():
        key, name = entry.rsplit("=", 1)
        flat[key] = flat[key].view(getattr(ml_dtypes, name))
    meta: Dict[str, Any] = {}
    if (path / _META_FILE).exists():
        with open(path / _META_FILE, encoding="utf-8") as f:
            meta = json.load(f)
    opt_keys = sorted(k for k in flat if k.startswith("opt_state/"))
    if opt_keys:
        meta["_opt_state"] = [flat[k] for k in opt_keys]
    return (_migrate_params(_unflatten(flat, "params")),
            _unflatten(flat, "batch_stats"), meta)


def _migrate_params(params: Any) -> Any:
    """Forward-migrate older checkpoint layouts.

    v0 → v1: BERT attention used separate query/key/value DenseGenerals;
    current layout is one fused qkv kernel [H, 3, heads, d]."""
    if not isinstance(params, dict):
        return params
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and {"query", "key", "value"} <= set(v) \
                and "qkv" not in v and "output" in v:
            q, kk, vv = v["query"], v["key"], v["value"]
            out[k] = {
                "qkv": {
                    "kernel": np.stack([np.asarray(q["kernel"]),
                                        np.asarray(kk["kernel"]),
                                        np.asarray(vv["kernel"])], axis=1),
                    "bias": np.stack([np.asarray(q["bias"]),
                                      np.asarray(kk["bias"]),
                                      np.asarray(vv["bias"])], axis=0),
                },
                "output": _migrate_params(v["output"]),
            }
        else:
            out[k] = _migrate_params(v)
    return out


def checkpoint_exists(path: str | Path) -> bool:
    return (Path(path) / _ARRAYS_FILE).exists()


def role_path(checkpoint_dir: str | Path, mode: str, role: str) -> Path:
    """best/last role path for a training mode."""
    return Path(checkpoint_dir) / f"{mode}_{role}"
