from multimodal_rare_disease.evaluation.evaluator import (  # noqa: F401
    Evaluator,
    compare_models,
)
from multimodal_rare_disease.evaluation.stats import (  # noqa: F401
    bootstrap_confidence_interval,
    chi_square_test,
    compare_multimodal_vs_unimodal,
    mcnemar_test,
)
