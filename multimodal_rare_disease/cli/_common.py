"""Shared CLI plumbing."""

from __future__ import annotations

import argparse
import ast
import logging
import os
from typing import Any, Dict, Optional

from multimodal_rare_disease.config import Config, resolve_config


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )


def compilation_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<repo>/.jax_cache`.

    A fixed path: the cache directory is part of the cache key, so a
    path that moved between runs would never hit."""
    from multimodal_rare_disease.config import BASE_DIR

    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(BASE_DIR / ".jax_cache"))


def enable_compilation_cache() -> None:
    """Point JAX at the persistent on-disk compilation cache.

    Every CLI entry point is a fresh process, and the flagship
    predictor/evaluator costs minutes of XLA compile cold — so without
    a persistent cache a notebook or shell script that chains CLI calls
    re-pays that compile per invocation. The cache keys on optimized
    HLO + compile options, so it is exact across processes.
    """
    import jax

    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())


def configure_platform(platform: Optional[str] = None) -> None:
    """Pin the JAX platform before first backend use.

    Resolution order: the `--platform` flag, then the MRD_PLATFORM env
    var, then JAX's default (the GPU where one is installed). `cpu` runs
    without the accelerator; `gpu` requires it — JAX raises at first use
    when no GPU is reachable, and nothing falls back to the CPU.
    """
    enable_compilation_cache()
    choice = platform or os.environ.get("MRD_PLATFORM")
    if choice and choice != "auto":
        import jax

        jax.config.update("jax_platforms", {"gpu": "cuda"}.get(choice,
                                                              choice))


def add_config_args(parser: argparse.ArgumentParser) -> None:
    from multimodal_rare_disease.config import PRESETS

    # choices derive from the PRESETS registry so a preset added in
    # config.py is immediately reachable from every CLI (a hardcoded
    # list silently rejected `from_scratch_fullsize` when it landed).
    parser.add_argument("--preset", default=None,
                        choices=sorted(PRESETS),
                        help="config preset (default: inferred from mode)")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="config override, e.g. --set training.batch_size=16")
    add_platform_arg(parser)


def add_platform_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--platform", default=None,
                        choices=["auto", "cpu", "gpu"],
                        help="JAX platform: auto (default; honors "
                             "MRD_PLATFORM env), cpu (run without the "
                             "accelerator), gpu (require the GPU)")


def build_config(args: argparse.Namespace, mode: str,
                 extra: Optional[Dict[str, Any]] = None) -> Config:
    preset = args.preset
    if preset is None:
        preset = {"multimodal": "multimodal", "image_only": "small_data",
                  "text_only": "default"}.get(mode, "default")
    overrides: Dict[str, Any] = dict(extra or {})
    for item in getattr(args, "overrides", []):
        if "=" not in item:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        key, value = item.split("=", 1)
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value
    return resolve_config(preset, overrides)
