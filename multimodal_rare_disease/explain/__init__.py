from multimodal_rare_disease.explain.gradcam import (  # noqa: F401
    GradCAM,
    gradcam_heatmap,
    overlay_heatmap,
)
from multimodal_rare_disease.explain.attention import (  # noqa: F401
    cross_modal_attention_summary,
    text_token_attention,
)
