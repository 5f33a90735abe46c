from multimodal_rare_disease.inference.predictor import (  # noqa: F401
    MultimodalPredictor,
    load_predictor,
)
