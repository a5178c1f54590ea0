"""Model factory: counterpart of ``fastscnn_tpu/models/registry.py``
(``get_fast_scnn``, reference:models/fast_scnn.py:240-256).

``DATASET_NUM_CLASSES`` and ``DATASET_ACRONYMS`` are the port's own copy
of the JAX package's tables: the ``NUM_CLASS`` constants of the
reference's four datasets, and the acronym in a checkpoint's name
(``fast_scnn_<acronym>.pth``). :func:`get_fast_scnn` resolves a dataset's
class count and builds the model, with a reference-format checkpoint's
weights when ``pretrained``.
"""

from __future__ import annotations

import os

__all__ = ["get_fast_scnn", "DATASET_NUM_CLASSES", "DATASET_ACRONYMS"]

DATASET_NUM_CLASSES = {
    "citys": 19,
    "tusimple": 2,
    "bdd100k": 2,  # binary drivable by default; ternary uses 3
    "custom": 2,
}

DATASET_ACRONYMS = {
    "pascal_voc": "voc",
    "pascal_aug": "voc",
    "ade20k": "ade",
    "coco": "coco",
    "citys": "citys",
    "tusimple": "tusimple",
    "bdd100k": "bdd100k",
    "custom": "custom",
}


def get_fast_scnn(
    dataset: str = "citys",
    pretrained: bool = False,
    root: str = "./weights",
    aux: bool = False,
    num_classes: int | None = None,
    seed: int = 0,
    device=None,
):
    """The FastSCNN of a named dataset, in eval mode on ``device`` (None:
    the CUDA card). ``pretrained=True`` loads ``<root>/fast_scnn_<acronym>.pth``
    (any of the three ``.pth`` dialects) through
    :func:`~fastscnn_tpu_torch.utils.checkpoint.load_pth_checkpoint`;
    otherwise the weights come from ``init_fast_scnn`` seeded with
    ``seed`` (a ``torch.Generator``: JAX's ``PRNGKey(seed)`` stream cannot
    be replayed, so the two packages' random models differ).
    :func:`~fastscnn_tpu_torch.models.convert.to_param_trees` gives the
    JAX ``(params, state)`` pair of the result."""
    import torch

    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.models.convert import from_jax_params
    from fastscnn_tpu_torch.models.fast_scnn import FastSCNN, init_fast_scnn
    from fastscnn_tpu_torch.utils.checkpoint import load_pth_checkpoint

    device = resolve_device(device)
    if num_classes is None:
        if dataset not in DATASET_NUM_CLASSES:
            raise ValueError(
                f"dataset {dataset!r} has no bundled loader/num_classes "
                f"(supported: {sorted(DATASET_NUM_CLASSES)}); pass "
                "num_classes= explicitly to build a model for it"
            )
        num_classes = DATASET_NUM_CLASSES[dataset]
    if not pretrained:
        return init_fast_scnn(num_classes, aux=aux,
                              generator=torch.Generator().manual_seed(seed), device=device)
    path = os.path.join(root, f"fast_scnn_{DATASET_ACRONYMS[dataset]}.pth")
    params, state = load_pth_checkpoint(path, num_classes, aux=aux or None)
    if not aux:  # the JAX model ignores a checkpoint's aux head when aux is off
        params = {k: v for k, v in params.items() if k != "auxlayer"}
        state = {k: v for k, v in state.items() if k != "auxlayer"}
    model = FastSCNN(num_classes, aux=aux)
    model.load_state_dict(from_jax_params(params, state), strict=True)
    return model.to(device).eval()
