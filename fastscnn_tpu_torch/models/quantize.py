"""Int8 pointwise-conv serving: the site list, calibration, the model.

Counterpart of ``fastscnn_tpu/models/quantize.py``:

- :data:`PW_INT8_SITES`: the 1×1 convs of ``apply_folded`` that may run in
  int8 — every pointwise conv but the heads (which stay in the compute
  dtype) and the four pooled PPM convs (too small to pay for a quantize).
- :func:`calibrate_pw_scales`: per-site symmetric scales, max|x| / 127 of
  each site's input over calibration batches.
- :func:`quantized_model`: a model that runs those sites through kernel B7
  (``'int8-a8'``) or B8 (``'int8-w8a8'``).

The int8 serving path is an ``InferenceEngine`` over a quantized model::

    scales = calibrate_pw_scales(model, fold_inference_params(model), batches,
                                 preprocess=normalize)   # on the 'conv' model
    engine = InferenceEngine(quantized_model(model, scales, "int8-w8a8"), ...)
"""

from __future__ import annotations

import torch

from fastscnn_tpu_torch.utils.tree import tree_leaves

__all__ = ["PW_INT8_SITES", "calibrate_pw_scales", "quantized_model"]


def _bottleneck_sites():
    for stage in (1, 2, 3):
        for i in range(3):
            yield f"gfe/bottleneck{stage}/{i}/expand"
            yield f"gfe/bottleneck{stage}/{i}/project"


PW_INT8_SITES: tuple[str, ...] = (
    "ltd/dsconv1/pw",
    "ltd/dsconv2/pw",
    *_bottleneck_sites(),
    "gfe/ppm/out",
    "ffm/conv_lower_res",
    "ffm/conv_higher_res",
    "cls/dsconv1/pw",
    "cls/dsconv2/pw",
)


class _SiteAmaxHook:
    """``act_fake_quant`` hook that records max|x| (f32) of each site's
    input, as a tensor on the input's device."""

    def __init__(self, sites):
        self.sites = frozenset(sites)
        self.amax = {}

    def __call__(self, y, site=None):
        if site in self.sites:
            m = y.float().abs().amax()
            self.amax[site] = torch.maximum(self.amax[site], m) if site in self.amax else m
        return y


def calibrate_pw_scales(model, folded, batches, sites=PW_INT8_SITES, preprocess=None):
    """Per-site symmetric int8 scales (max|x| / 127) over ``batches``.

    ``batches``: NHWC arrays or tensors fed to ``apply_folded`` (after
    ``preprocess`` when given: pass the serving normalisation so the scales
    match deployment inputs). The sites run as cuDNN convs
    (``folded_pw_impl='conv'``) and the model keeps its ``folded_dw_impl``:
    with 'fused-ds' or 'fused-ds-mr' the LTD's 1×1s are inside a kernel and
    never reached, which raises ``ValueError`` as in JAX — calibrate on the
    'conv' model and apply the scales to any configuration. Returns the
    sorted, hashable tuple of ``(site, scale)`` pairs that
    :func:`quantized_model` takes (1.0 for a site whose input is all 0)."""
    hook = _SiteAmaxHook(sites)
    qmodel = model.with_options(act_fake_quant=hook, folded_pw_impl="conv", pw_act_scales=())
    device = tree_leaves(folded)[0].device
    total: dict[str, float] = {}
    with torch.inference_mode():
        for b in batches:
            hook.amax = {}
            x = torch.as_tensor(b, device=device)
            qmodel.apply_folded(folded, preprocess(x) if preprocess is not None else x,
                                upsample_outputs=False)
            for k, v in hook.amax.items():
                total[k] = max(total.get(k, 0.0), float(v))
    missing = set(sites) - set(total)
    if missing:
        raise ValueError(f"sites never reached during calibration: {sorted(missing)}")
    return tuple(sorted((k, (v / 127.0) if v > 0 else 1.0) for k, v in total.items()))


def quantized_model(model, scales, impl: str = "int8-a8"):
    """A model sharing ``model``'s weights whose calibrated 1×1 sites run
    through kernel B7 (``impl='int8-a8'``) or B8 (``'int8-w8a8'``); no
    ``act_fake_quant`` hook."""
    if impl not in ("int8-a8", "int8-w8a8"):
        raise ValueError(f"unknown int8 pw impl: {impl!r}")
    return model.with_options(folded_pw_impl=impl, pw_act_scales=tuple(scales),
                              act_fake_quant=None)
