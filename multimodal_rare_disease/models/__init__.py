from multimodal_rare_disease.models.resnet import ResNet50Encoder  # noqa: F401
from multimodal_rare_disease.models.efficientnet import EfficientNetB0Encoder  # noqa: F401
from multimodal_rare_disease.models.cnn_encoder import CNNEncoder, create_cnn_encoder  # noqa: F401
from multimodal_rare_disease.models.bert import BertEncoder, TextEncoder, create_text_encoder  # noqa: F401
from multimodal_rare_disease.models.fusion import (  # noqa: F401
    ConcatenationFusion,
    AttentionFusion,
    GatedFusion,
    create_fusion_module,
)
from multimodal_rare_disease.models.classifier import (  # noqa: F401
    ClassificationHead,
    MultimodalClassifier,
    ImageOnlyClassifier,
    TextOnlyClassifier,
    create_model,
)
