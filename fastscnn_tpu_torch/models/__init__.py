from fastscnn_tpu_torch.models.convert import from_jax_params, load_checkpoint, to_param_trees
from fastscnn_tpu_torch.models.fast_scnn import (
    FOLDED_DW_IMPLS,
    STEM_IMPLS,
    FastSCNN,
    fold_inference_params,
    init_fast_scnn,
)

__all__ = [
    "FOLDED_DW_IMPLS",
    "STEM_IMPLS",
    "FastSCNN",
    "fold_inference_params",
    "from_jax_params",
    "init_fast_scnn",
    "load_checkpoint",
    "to_param_trees",
]
