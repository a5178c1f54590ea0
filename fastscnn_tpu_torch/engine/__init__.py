from fastscnn_tpu_torch.engine.infer import (
    FINAL_UPSAMPLE_MODES,
    IMAGENET_MEAN,
    IMAGENET_STD,
    E2EConfig,
    InferenceEngine,
)

__all__ = ["E2EConfig", "FINAL_UPSAMPLE_MODES", "IMAGENET_MEAN", "IMAGENET_STD", "InferenceEngine"]
