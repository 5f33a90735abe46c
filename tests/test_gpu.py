"""Numerics on the real GPU (`python -m pytest tests -m gpu` on the GPU
machine; skipped elsewhere by the `gpu_devices` fixture)."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_golden_forward_matches_cpu_pin_on_gpu(gpu_devices):
    """The pinned (CPU) golden forward, recomputed on the card under
    "highest" matmul precision."""
    assert chip_smoke.check_golden() <= chip_smoke.GOLDEN_ATOL


def test_device_memory_limit_reported_on_gpu(gpu_devices):
    from multimodal_rare_disease.train.trainer import (
        device_memory_limit_bytes,
    )

    assert device_memory_limit_bytes(gpu_devices[0]) > 1e9
