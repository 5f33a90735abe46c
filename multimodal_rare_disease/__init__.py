"""Multimodal rare genetic disease diagnosis framework.

A ground-up JAX/XLA re-design with the capabilities of the
PyTorch reference (ArshvirSk/Multimodal-Rare-Disease): CNN facial-image
encoders (ResNet50 / EfficientNet-B0), a biomedical BERT clinical-text
encoder, three fusion strategies (concatenation / cross-modal attention /
gated), classification over 10 rare syndromes, training / evaluation /
statistical-validation / explainability / inference pipelines.

Everything on the compute path is functional JAX compiled by XLA for the
GPU (an NVIDIA H100), with `jax.sharding.Mesh` + NamedSharding data and
tensor parallelism.
"""

__version__ = "0.1.0"

from multimodal_rare_disease.config import (  # noqa: F401
    Config,
    get_config,
    resolve_config,
    SYNDROME_NAMES,
)
