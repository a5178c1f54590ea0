from fastscnn_tpu_torch.models.convert import from_jax_params, load_checkpoint, to_param_trees
from fastscnn_tpu_torch.models.fast_scnn import (
    FOLDED_DW_IMPLS,
    FOLDED_PW_IMPLS,
    STEM_IMPLS,
    FastSCNN,
    fold_inference_params,
    init_fast_scnn,
)
from fastscnn_tpu_torch.models.quantize import PW_INT8_SITES, calibrate_pw_scales, quantized_model
from fastscnn_tpu_torch.models.registry import DATASET_ACRONYMS, DATASET_NUM_CLASSES

__all__ = [
    "DATASET_ACRONYMS",
    "DATASET_NUM_CLASSES",
    "FOLDED_DW_IMPLS",
    "FOLDED_PW_IMPLS",
    "PW_INT8_SITES",
    "STEM_IMPLS",
    "FastSCNN",
    "calibrate_pw_scales",
    "fold_inference_params",
    "from_jax_params",
    "init_fast_scnn",
    "load_checkpoint",
    "quantized_model",
    "to_param_trees",
]
