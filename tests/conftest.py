"""Test configuration.

The CPU tier (everything not marked `gpu`) runs on the CPU backend with
8 virtual devices, so multi-device sharding paths run without
accelerator hardware. Tests marked `gpu` need the real card: on the GPU
machine run `python -m pytest tests -m gpu`, which leaves JAX on its
default (GPU) platform; elsewhere they skip from the `gpu_devices`
fixture.
"""

import os

import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


# Test tiers (pyproject markers):
#   pytest -m smoke        every-commit gate: compile-light modules
#   pytest -m "not slow"   pre-snapshot gate
#   pytest                 full suite incl. one-epoch trainings
#   pytest -m gpu          numerics on the real GPU (GPU machine only)
_SMOKE_MODULES = {
    "test_config.py", "test_parsers.py", "test_tokenizer.py",
    "test_checkpoint.py", "test_stats.py", "test_images.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.path is not None and item.path.name in _SMOKE_MODULES:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture
def gpu_devices():
    """The visible GPUs; skips the test where JAX found none."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {devices[0].platform}); "
                    "run `python -m pytest tests -m gpu` on the GPU machine")
    return devices


@pytest.fixture(scope="session")
def mesh8():
    from multimodal_rare_disease.parallel import create_mesh

    return create_mesh()


@pytest.fixture(scope="session")
def default_cfg():
    from multimodal_rare_disease.config import resolve_config

    return resolve_config()
