from multimodal_rare_disease.ops.preprocess import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    affine_resample,
    augment_batch,
    eval_preprocess,
    normalize_images,
    train_preprocess,
)
