from multimodal_rare_disease.utils import rng  # noqa: F401
