"""Fast-SCNN as a PyTorch module, plus the BN-folded serving graph.

Counterpart of ``fastscnn_tpu/models/fast_scnn.py``. The submodule names
are the reference ``state_dict`` keys (``models/convert.py::build_key_map``),
so a JAX-initialised model and a real ``fast_scnn_*.pth`` both load with
``strict=True``.

- ``FastSCNN.forward``: the unfolded eval-mode graph (the JAX ``apply``
  with ``training=False``). NHWC in and out; inside, NCHW tensors in
  ``channels_last`` memory, which are physically NHWC.
- ``FastSCNN.apply_params``: the JAX ``apply`` on ``(params, state)``
  trees (:func:`~fastscnn_tpu_torch.models.convert.to_param_trees`
  layout, HWIO) — training mode with batch-stat BN that returns the new
  running statistics, or eval mode on running statistics. The LTD stem's
  convs are routed by ``stem_impl``: ``'xla'`` (cuDNN and autograd),
  ``'tapbwd'`` (:func:`~fastscnn_tpu_torch.ops.conv.conv2d_tapbwd`),
  ``'taps'`` and ``'taps-packbn'`` (depthwise convs as the tap sums of
  :func:`~fastscnn_tpu_torch.ops.conv.dw_conv2d_taps`, the others through
  ``conv2d_tapbwd``; '-packbn' asks the stem's BN for the JAX package's
  packed lane layout, which here is the same computation) or ``'pallas'``
  (depthwise convs through kernel B6, the others through
  ``conv2d_tapbwd``). This is the graph the train and eval steps
  (``parallel/train.py``) differentiate and run.
- :func:`fold_inference_params` and ``FastSCNN.apply_folded``: the
  serving graph on BN-folded HWIO ``{w, b}`` trees, with the LTD stem's
  depthwise convs routed by ``folded_dw_impl`` — ``'conv'`` (cuDNN),
  ``'taps'`` (``dw_conv2d_taps`` + ReLU, plain PyTorch), ``'pallas'``
  (kernel B4, dw + bias + ReLU), ``'fused-ds'`` (kernel B3,
  the whole DSConv) or ``'fused-ds-mr'`` (kernel B5, B3's function over
  several output rows a block) — and the calibrated 1×1 sites routed by
  ``folded_pw_impl`` — ``'conv'`` (cuDNN), ``'int8-a8'`` (kernel B7) or
  ``'int8-w8a8'`` (kernel B8), or their plain versions where
  ``pw_use_pallas`` is False; see :mod:`~fastscnn_tpu_torch.models.quantize`.
  ``act_fake_quant`` is the JAX model's hook on every conv input. The JAX
  names are kept so configurations map one to one.
"""

from __future__ import annotations

import copy
import inspect
import math

import torch
import torch.nn as nn

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.models.convert import to_param_trees
from fastscnn_tpu_torch.ops.conv import (
    batch_norm_apply,
    batch_norm_train,
    conv2d,
    conv2d_tapbwd,
    dw_conv2d_taps,
    fold_conv_bn,
)
from fastscnn_tpu_torch.ops.cuda.dw_conv import (
    ds_conv3x3_pw,
    ds_conv3x3_pw_multirow,
    dw_conv3x3,
    dw_conv3x3_vjp,
)
from fastscnn_tpu_torch.ops.cuda.int8_pw import (
    pw_conv_a8,
    pw_conv_a8_reference,
    pw_conv_w8a8,
    pw_conv_w8a8_reference,
    quantize_act,
)
from fastscnn_tpu_torch.ops.pool import adaptive_avg_pool
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_matmul
from fastscnn_tpu_torch.utils.tree import tree_map

__all__ = [
    "FastSCNN",
    "init_fast_scnn",
    "fold_inference_params",
    "FOLDED_DW_IMPLS",
    "FOLDED_PW_IMPLS",
    "STEM_IMPLS",
]

FOLDED_DW_IMPLS = ("conv", "taps", "pallas", "fused-ds", "fused-ds-mr")
FOLDED_PW_IMPLS = ("conv", "int8-a8", "int8-w8a8")
STEM_IMPLS = ("xla", "tapbwd", "taps", "taps-packbn", "pallas")


class _ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, k, stride, padding, bias=False),
            nn.BatchNorm2d(cout),
            nn.ReLU(True),
        )

    def forward(self, x):
        return self.conv(x)


class _DSConv(nn.Module):
    """Depthwise separable conv: dw 3×3 + BN + ReLU, pw 1×1 + BN + ReLU."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
            nn.BatchNorm2d(cin),
            nn.ReLU(True),
            nn.Conv2d(cin, cout, 1, bias=False),
            nn.BatchNorm2d(cout),
            nn.ReLU(True),
        )

    def forward(self, x):
        return self.conv(x)


class _DWConv(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, stride, 1, groups=cin, bias=False),
            nn.BatchNorm2d(cout),
            nn.ReLU(True),
        )

    def forward(self, x):
        return self.conv(x)


class _LinearBottleneck(nn.Module):
    """MobileNetV2 inverted residual."""

    def __init__(self, cin, cout, t=6, stride=2):
        super().__init__()
        self.use_shortcut = stride == 1 and cin == cout
        self.block = nn.Sequential(
            _ConvBNReLU(cin, cin * t, 1),
            _DWConv(cin * t, cin * t, stride),
            nn.Conv2d(cin * t, cout, 1, bias=False),
            nn.BatchNorm2d(cout),
        )

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_shortcut else out


_PPM_SIZES = (1, 2, 3, 6)


class _PyramidPooling(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        inter = cin // 4
        self.conv1 = _ConvBNReLU(cin, inter, 1)
        self.conv2 = _ConvBNReLU(cin, inter, 1)
        self.conv3 = _ConvBNReLU(cin, inter, 1)
        self.conv4 = _ConvBNReLU(cin, inter, 1)
        self.out = _ConvBNReLU(cin * 2, cout, 1)

    def forward(self, x, sizes=_PPM_SIZES, align_corners=True):
        size = (x.shape[2], x.shape[3])
        feats = [x]
        for conv, s in zip((self.conv1, self.conv2, self.conv3, self.conv4), sizes):
            y = conv(adaptive_avg_pool(x, s, h_axis=2, w_axis=3))
            feats.append(resize_bilinear(y, size, align_corners, h_axis=2, w_axis=3))
        return self.out(torch.cat(feats, dim=1))


class _LearningToDownsample(nn.Module):
    def __init__(self, c1=32, c2=48, cout=64):
        super().__init__()
        self.conv = _ConvBNReLU(3, c1, 3, 2)
        self.dsconv1 = _DSConv(c1, c2, 2)
        self.dsconv2 = _DSConv(c2, cout, 2)

    def forward(self, x):
        return self.dsconv2(self.dsconv1(self.conv(x)))


class _GlobalFeatureExtractor(nn.Module):
    def __init__(self, cin=64, blocks=(64, 96, 128), cout=128, t=6, nums=(3, 3, 3)):
        super().__init__()
        chans = (cin, *blocks)
        for stage, (n, stride) in enumerate(zip(nums, (2, 2, 1)), start=1):
            layers = [
                _LinearBottleneck(chans[stage - 1] if i == 0 else chans[stage], chans[stage], t,
                                  stride if i == 0 else 1)
                for i in range(n)
            ]
            self.add_module(f"bottleneck{stage}", nn.Sequential(*layers))
        self.ppm = _PyramidPooling(blocks[-1], cout)

    def forward(self, x, ppm_sizes=_PPM_SIZES, ppm_align_corners=True):
        x = self.bottleneck3(self.bottleneck2(self.bottleneck1(x)))
        return self.ppm(x, ppm_sizes, ppm_align_corners)


class _FeatureFusionModule(nn.Module):
    def __init__(self, higher_in=64, lower_in=128, cout=128):
        super().__init__()
        self.dwconv = _DWConv(lower_in, cout, 1)
        self.conv_lower_res = nn.Sequential(nn.Conv2d(cout, cout, 1), nn.BatchNorm2d(cout))
        self.conv_higher_res = nn.Sequential(nn.Conv2d(higher_in, cout, 1), nn.BatchNorm2d(cout))

    def forward(self, higher, lower):
        size = (higher.shape[2], higher.shape[3])
        lower = self.dwconv(resize_bilinear(lower, size, True, h_axis=2, w_axis=3))
        lower = self.conv_lower_res(lower)
        return torch.relu(self.conv_higher_res(higher) + lower)


class _Classifier(nn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.dsconv1 = _DSConv(cin, cin, 1)
        self.dsconv2 = _DSConv(cin, cin, 1)
        self.conv = nn.Sequential(nn.Dropout(0.1), nn.Conv2d(cin, num_classes, 1))

    def forward(self, x):
        return self.conv(self.dsconv2(self.dsconv1(x)))


class FastSCNN(nn.Module):
    """Fast-SCNN with the reference module tree.

    Besides the network it carries the JAX model's options
    ``folded_dw_impl`` ∈ :data:`FOLDED_DW_IMPLS`, ``folded_pw_impl`` ∈
    :data:`FOLDED_PW_IMPLS` with its ``pw_act_scales`` (a tuple of
    ``(site, scale)`` pairs) and ``pw_use_pallas``, and ``act_fake_quant``
    (serving), and ``stem_impl`` ∈ :data:`STEM_IMPLS` and ``dropout_rate``
    (``apply_params``), and the deployment-graph knobs ``ppm_sizes`` (the
    pyramid pooling's four bin counts) and ``ppm_align_corners`` (its
    upsamples' convention), used by every forward. Their defaults, (1, 2,
    3, 6) and True, are the training graph; (1, 2, 4, 8) and False are the
    reference's deployed ATC graph, which ``export_model --atc-compat``
    builds (reference:export_onnx_fixed.py:100-163). :meth:`with_options`
    is the JAX ``dataclasses.replace``: a model with other options that
    shares these weights.

    ``pw_use_pallas`` routes the int8 sites as the JAX model's field does:
    None runs kernel B7 or B8 on a CUDA tensor and its plain version on a
    CPU tensor; False runs the plain version on either (the JAX package's
    XLA path); True runs the kernel and raises on a CPU tensor.
    """

    def __init__(
        self,
        num_classes: int,
        aux: bool = False,
        folded_dw_impl: str = "conv",
        folded_pw_impl: str = "conv",
        act_fake_quant=None,
        stem_impl: str = "xla",
        dropout_rate: float = 0.1,
        pw_act_scales: tuple = (),
        ppm_sizes: tuple = _PPM_SIZES,
        ppm_align_corners: bool = True,
        pw_use_pallas: bool | None = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.aux = aux
        self._set_options(folded_dw_impl=folded_dw_impl, folded_pw_impl=folded_pw_impl,
                          act_fake_quant=act_fake_quant, stem_impl=stem_impl,
                          dropout_rate=dropout_rate, pw_act_scales=pw_act_scales,
                          ppm_sizes=ppm_sizes, ppm_align_corners=ppm_align_corners,
                          pw_use_pallas=pw_use_pallas)
        self.learning_to_downsample = _LearningToDownsample(32, 48, 64)
        self.global_feature_extractor = _GlobalFeatureExtractor(64, (64, 96, 128), 128, 6, (3, 3, 3))
        self.feature_fusion = _FeatureFusionModule(64, 128, 128)
        self.classifier = _Classifier(128, num_classes)
        if aux:
            self.auxlayer = nn.Sequential(
                nn.Conv2d(64, 32, 3, padding=1, bias=False),
                nn.BatchNorm2d(32),
                nn.ReLU(True),
                nn.Dropout(0.1),
                nn.Conv2d(32, num_classes, 1),
            )

    _OPTIONS = ("folded_dw_impl", "folded_pw_impl", "act_fake_quant", "stem_impl",
                "dropout_rate", "pw_act_scales", "ppm_sizes", "ppm_align_corners",
                "pw_use_pallas")

    def _set_options(self, **options):
        for option, allowed in (("stem_impl", STEM_IMPLS), ("folded_dw_impl", FOLDED_DW_IMPLS),
                                ("folded_pw_impl", FOLDED_PW_IMPLS)):
            if options[option] not in allowed:
                raise ValueError(f"unknown {option} {options[option]!r}")
        options["pw_act_scales"] = tuple(options["pw_act_scales"])
        options["ppm_sizes"] = tuple(int(s) for s in options["ppm_sizes"])
        if len(options["ppm_sizes"]) != 4:
            raise ValueError(f"ppm_sizes needs one bin count for each of the 4 pyramid "
                             f"convs, got {options['ppm_sizes']}")
        options["ppm_align_corners"] = bool(options["ppm_align_corners"])
        if options["pw_use_pallas"] not in (None, True, False):
            raise ValueError(f"pw_use_pallas is None, True or False, not "
                             f"{options['pw_use_pallas']!r}")
        self.__dict__.update(options)
        self._int8_weights = {}  # site -> (folded w, scale, prepared operands)

    def with_options(self, **changes) -> "FastSCNN":
        """A model with some options changed that shares this one's
        submodules, weights included (the JAX ``dataclasses.replace``)."""
        unknown = set(changes) - set(self._OPTIONS)
        if unknown:
            raise TypeError(f"not an option of FastSCNN: {sorted(unknown)}")
        new = copy.copy(self)
        new._set_options(**{k: changes.get(k, getattr(self, k)) for k in self._OPTIONS})
        return new

    def forward(self, x: torch.Tensor, upsample_outputs: bool = True):
        """NHWC input → tuple of NHWC logits, ``(main,)`` or ``(main, aux)``,
        at the input resolution (``upsample_outputs``) or at 1/8. Matches
        the JAX ``apply(training=False)`` in eval mode; training mode runs
        the reference's own BN and dropout semantics."""
        size = (x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)  # NHWC memory as a channels_last NCHW tensor
        higher = self.learning_to_downsample(x)
        lower = self.global_feature_extractor(higher, self.ppm_sizes, self.ppm_align_corners)
        outs = [self.classifier(self.feature_fusion(higher, lower))]
        if self.aux:
            outs.append(self.auxlayer(higher))
        if upsample_outputs:
            outs = [resize_bilinear(o, size, True, h_axis=2, w_axis=3) for o in outs]
        return tuple(o.permute(0, 2, 3, 1) for o in outs)

    # -- forward on parameter trees (train and eval steps) -------------------
    def apply_params(self, params, state, x, training: bool = False,
                     generator: torch.Generator | None = None, upsample_outputs: bool = True):
        """The JAX ``FastSCNN.apply``: NHWC ``x``, ``(params, state)`` trees
        in the :func:`~fastscnn_tpu_torch.models.convert.to_param_trees`
        layout → ``(outputs, new_state)``, ``outputs`` the tuple of NHWC
        logits ``(main,)`` or ``(main, aux)``, at the input resolution or,
        with ``upsample_outputs=False``, at 1/8 (the losses upsample).

        ``training=True``: batch-stat BN (``batch_norm_train``), and
        ``new_state`` holds the updated running statistics (f32); dropout
        (rate ``dropout_rate``) only when a ``generator`` on ``x``'s device
        is given, its mask drawn from that generator. ``training=False``:
        BN on the running statistics, which ``new_state`` holds unchanged. Params
        may be in any dtype (the train step passes bf16 casts of f32
        masters); the compute runs in ``x``'s dtype."""
        run = _TreeForward(self, training, generator)
        size = (x.shape[1], x.shape[2])
        new_state = {}
        higher, new_state["learning_to_downsample"] = run.ltd(
            params["learning_to_downsample"], state["learning_to_downsample"], x)
        lower, new_state["global_feature_extractor"] = run.gfe(
            params["global_feature_extractor"], state["global_feature_extractor"], higher)
        fused, new_state["feature_fusion"] = run.ffm(
            params["feature_fusion"], state["feature_fusion"], higher, lower)
        logits, new_state["classifier"] = run.classifier(
            params["classifier"], state["classifier"], fused)
        outputs = [logits]
        if self.aux:
            auxout, new_state["auxlayer"] = run.aux(params["auxlayer"], state["auxlayer"], higher)
            outputs.append(auxout)
        if upsample_outputs:
            outputs = [resize_bilinear(o, size, align_corners=True) for o in outputs]
        return tuple(outputs), new_state

    # -- folded inference ---------------------------------------------------
    def apply_folded(self, fparams, x: torch.Tensor, upsample_outputs: bool = True):
        """Inference forward on a BN-folded tree (:func:`fold_inference_params`):
        every block is conv + bias (+ ReLU). NHWC in, tuple of NHWC logits
        out; ``upsample_outputs=False`` returns 1/8-resolution logits so the
        caller picks the upsample formulation.

        Every conv input passes through ``act_fake_quant`` (called with the
        JAX site name when it takes a ``site`` argument), except at the int8
        sites: with ``folded_pw_impl`` 'int8-a8' or 'int8-w8a8', each site
        of ``pw_act_scales`` quantizes its input and runs kernel B7 or B8,
        whose output is bf16 whatever the compute dtype (later ops promote
        as the JAX graph does). With 'fused-ds' or 'fused-ds-mr' the LTD's
        two 1×1s run inside B3 or B5 and bypass both."""
        impl = self.folded_dw_impl
        aq = _site_hook(self.act_fake_quant)
        int8_scales = dict(self.pw_act_scales) if self.folded_pw_impl != "conv" else {}

        def cbr(p, y, stride=1, padding=0, groups=1, relu=True, site=None):
            if site is not None and site in int8_scales:
                return self._pw_int8(p, y, site, int8_scales[site], relu)
            y = conv2d(aq(y, site), p["w"], p["b"], stride=stride, padding=padding, groups=groups)
            return torch.relu(y) if relu else y

        def ds(p, y, stride=1, dw_alt=False, site=None):
            if dw_alt and impl in ("fused-ds", "fused-ds-mr"):
                # the whole DSConv in kernel B3 (one output row a block) or
                # B5 (several): the dw activation never reaches device memory
                fn = ds_conv3x3_pw if impl == "fused-ds" else ds_conv3x3_pw_multirow
                return fn(y.contiguous(), p["dw"]["w"], p["dw"]["b"], p["pw"]["w"], p["pw"]["b"],
                          stride=stride, padding=1)
            if dw_alt and impl == "taps":
                y = torch.relu(dw_conv2d_taps(y, p["dw"]["w"], p["dw"]["b"], stride=stride,
                                              padding=1))
            elif dw_alt:  # 'pallas': dw + bias + ReLU in kernel B4
                y = dw_conv3x3(y.contiguous(), p["dw"]["w"], p["dw"]["b"], stride=stride,
                               padding=1, relu=True)
            else:
                y = cbr(p["dw"], y, stride=stride, padding=1, groups=y.shape[-1],
                        site=site and f"{site}/dw")
            return cbr(p["pw"], y, site=site and f"{site}/pw")

        def bottleneck(p, y, stride, site):
            z = cbr(p["expand"], y, site=f"{site}/expand")
            z = cbr(p["dw"], z, stride=stride, padding=1, groups=z.shape[-1], site=f"{site}/dw")
            z = cbr(p["project"], z, relu=False, site=f"{site}/project")
            if stride == 1 and y.shape[-1] == z.shape[-1]:
                z = y + z
            return z

        size = (x.shape[1], x.shape[2])
        p = fparams
        dw_alt = impl != "conv"
        ltd = p["learning_to_downsample"]
        y = cbr(ltd["conv"], x, stride=2, site="ltd/conv")
        y = ds(ltd["dsconv1"], y, stride=2, dw_alt=dw_alt, site="ltd/dsconv1")
        higher = ds(ltd["dsconv2"], y, stride=2, dw_alt=dw_alt, site="ltd/dsconv2")
        g = p["global_feature_extractor"]
        y = higher
        for name, stride in (("bottleneck1", 2), ("bottleneck2", 2), ("bottleneck3", 1)):
            for i, bp in enumerate(g[name]):
                y = bottleneck(bp, y, stride if i == 0 else 1, site=f"gfe/{name}/{i}")
        psize = (y.shape[1], y.shape[2])
        feats = [y]
        for conv_name, pool_size in zip(("conv1", "conv2", "conv3", "conv4"), self.ppm_sizes):
            z = cbr(g["ppm"][conv_name], adaptive_avg_pool(y, pool_size), site=f"gfe/ppm/{conv_name}")
            feats.append(resize_bilinear_matmul(z, psize, align_corners=self.ppm_align_corners))
        lower = cbr(g["ppm"]["out"], torch.cat(feats, dim=-1), site="gfe/ppm/out")
        f = p["feature_fusion"]
        lo = resize_bilinear_matmul(lower, (higher.shape[1], higher.shape[2]), align_corners=True)
        lo = cbr(f["dwconv"], lo, padding=1, groups=lo.shape[-1], site="ffm/dwconv")
        lo = cbr(f["conv_lower_res"], lo, relu=False, site="ffm/conv_lower_res")
        hi = cbr(f["conv_higher_res"], higher, relu=False, site="ffm/conv_higher_res")
        fused = torch.relu(hi + lo)
        c = p["classifier"]
        y = ds(c["dsconv2"], ds(c["dsconv1"], fused, site="cls/dsconv1"), site="cls/dsconv2")
        logits = conv2d(aq(y, "cls/conv"), c["conv"]["w"], c["conv"]["b"])
        if upsample_outputs:
            logits = resize_bilinear_matmul(logits, size, align_corners=True)
        if self.aux and "auxlayer" in p:
            a = p["auxlayer"]
            z = cbr(a["conv1"], higher, padding=1, site="aux/conv1")
            auxout = conv2d(aq(z, "aux/conv2"), a["conv2"]["w"], a["conv2"]["b"])
            if upsample_outputs:
                auxout = resize_bilinear_matmul(auxout, size, align_corners=True)
            return (logits, auxout)
        return (logits,)


    def _pw_int8(self, p, y, site, scale, relu):
        """One int8 1×1 site: quantize the input with the site's scale, then
        kernel B7 or B8 on the folded weight (their plain versions where
        ``pw_use_pallas`` is False). The weight fold (JAX
        ``pw_int8``) depends on the weights and the scale only, so it is
        made at a site's first call and reused while the tree holds the
        same weight tensor."""
        if tuple(p["w"].shape[:2]) != (1, 1):
            raise ValueError(f"int8 pw site {site!r} is not a 1×1 conv: {tuple(p['w'].shape)}")
        hit = self._int8_weights.get(site)
        if hit is None or hit[0] is not p["w"] or hit[1] != scale:
            hit = (p["w"], scale, _fold_int8_weights(p["w"], scale, self.folded_pw_impl))
            self._int8_weights[site] = hit
        s, *w = hit[2]
        if self.pw_use_pallas and y.device.type == "cpu":
            raise ValueError(f"pw_use_pallas=True runs kernels B7 and B8, which take CUDA "
                             f"tensors; site {site!r} is on the CPU")
        q = quantize_act(y, s)
        plain = self.pw_use_pallas is False
        if self.folded_pw_impl == "int8-a8":
            return (pw_conv_a8_reference if plain else pw_conv_a8)(q, w[0], p["b"], relu=relu)
        return (pw_conv_w8a8_reference if plain else pw_conv_w8a8)(q, w[0], w[1], p["b"],
                                                                   relu=relu)


def _site_hook(hook):
    """``act_fake_quant`` as a ``(y, site) -> y`` function: the identity
    for None, the hook itself when it takes ``site`` (by name or
    ``**kwargs``), else a site-less ``y -> y`` hook called without it."""
    if hook is None:
        return lambda y, site=None: y
    try:
        params = inspect.signature(hook).parameters
        takes_site = "site" in params or any(
            q.kind is inspect.Parameter.VAR_KEYWORD for q in params.values())
    except (ValueError, TypeError):
        takes_site = False
    return hook if takes_site else (lambda y, site=None: hook(y))


def _fold_int8_weights(w, scale: float, impl: str):
    """The JAX ``pw_int8`` weight fold of a (1, 1, K, N) folded weight at
    activation scale ``scale``: (s, w_eff) for 'int8-a8', w_eff =
    bf16(f32(w) · s); (s, w_q, cs) for 'int8-w8a8', with the per-output-
    channel s_w = amax/127 (1 where amax is 0), w_q = clip(round(w / s_w),
    ±127) and cs = s · s_w. s is ``scale`` as an f32 tensor on ``w``'s
    device; every division is a true f32 division, as in JAX."""
    s = torch.tensor(scale, dtype=torch.float32, device=w.device)
    wf = w[0, 0].float()
    if impl == "int8-a8":
        return s, (wf * s).to(torch.bfloat16)
    amax = wf.abs().amax(dim=0)
    s_w = torch.where(amax > 0, amax / torch.tensor(127.0, device=w.device), torch.ones_like(amax))
    w_q = torch.round(wf / s_w).clamp(-127.0, 127.0).to(torch.int8)
    return s, w_q, s * s_w


class _TreeForward:
    """The blocks of ``FastSCNN.apply_params``, each ``(p, s, x) -> (y,
    new_s)`` on NHWC activations — the JAX package's ``_apply_*`` and
    module functions."""

    def __init__(self, model: FastSCNN, training: bool, generator):
        self.training = training
        self.generator = generator
        self.dropout_rate = model.dropout_rate
        self.ppm_sizes, self.ppm_align_corners = model.ppm_sizes, model.ppm_align_corners
        impl = model.stem_impl
        self.stem_bn_packed = impl == "taps-packbn"
        if impl == "xla":
            self.stem_conv = conv2d
        elif impl == "tapbwd":
            self.stem_conv = conv2d_tapbwd
        else:  # 'taps', 'taps-packbn' and 'pallas' route the depthwise convs
            dw = dw_conv2d_taps if impl in ("taps", "taps-packbn") else dw_conv3x3_vjp

            def stem_conv(x, w, stride=1, padding=0, groups=1):
                if groups > 1:
                    return dw(x, w, stride=stride, padding=padding)
                return conv2d_tapbwd(x, w, stride=stride, padding=padding, groups=groups)

            self.stem_conv = stem_conv

    def bn(self, p, s, x, packed=False):
        if self.training:
            y, m, v = batch_norm_train(x, p["scale"], p["bias"], s["mean"], s["var"],
                                       packed=packed)
            return y, {"mean": m, "var": v}
        return batch_norm_apply(x, p["scale"], p["bias"], s["mean"], s["var"]), s

    def cbr(self, p, s, x, stride=1, padding=0, groups=1, relu=True, conv_fn=conv2d,
            packed=False):
        y = conv_fn(x, p["w"], stride=stride, padding=padding, groups=groups)
        y, s_bn = self.bn(p["bn"], s["bn"], y, packed)
        return (torch.relu(y) if relu else y), {"bn": s_bn}

    def ds(self, p, s, x, stride=1, conv_fn=conv2d, packed=False):
        y, s_dw = self.cbr(p["dw"], s["dw"], x, stride=stride, padding=1, groups=x.shape[-1],
                           conv_fn=conv_fn, packed=packed)
        y, s_pw = self.cbr(p["pw"], s["pw"], y, conv_fn=conv_fn, packed=packed)
        return y, {"dw": s_dw, "pw": s_pw}

    def bottleneck(self, p, s, x, stride):
        y, s_e = self.cbr(p["expand"], s["expand"], x)
        y, s_d = self.cbr(p["dw"], s["dw"], y, stride=stride, padding=1, groups=y.shape[-1])
        y = conv2d(y, p["project"]["w"])
        y, s_p = self.bn(p["project"]["bn"], s["project"]["bn"], y)
        if stride == 1 and x.shape[-1] == y.shape[-1]:
            y = x + y
        return y, {"expand": s_e, "dw": s_d, "project": {"bn": s_p}}

    def ltd(self, p, s, x):
        conv, packed = self.stem_conv, self.stem_bn_packed
        y, s1 = self.cbr(p["conv"], s["conv"], x, stride=2, conv_fn=conv, packed=packed)
        y, s2 = self.ds(p["dsconv1"], s["dsconv1"], y, stride=2, conv_fn=conv, packed=packed)
        y, s3 = self.ds(p["dsconv2"], s["dsconv2"], y, stride=2, conv_fn=conv, packed=packed)
        return y, {"conv": s1, "dsconv1": s2, "dsconv2": s3}

    def gfe(self, p, s, x):
        ns = {}
        for name, stride in (("bottleneck1", 2), ("bottleneck2", 2), ("bottleneck3", 1)):
            stage = []
            for i, (bp, bs) in enumerate(zip(p[name], s[name])):
                x, s_i = self.bottleneck(bp, bs, x, stride if i == 0 else 1)
                stage.append(s_i)
            ns[name] = stage
        size = (x.shape[1], x.shape[2])
        feats, ppm = [x], {}
        for name, pool_size in zip(("conv1", "conv2", "conv3", "conv4"), self.ppm_sizes):
            y, ppm[name] = self.cbr(p["ppm"][name], s["ppm"][name], adaptive_avg_pool(x, pool_size))
            feats.append(resize_bilinear(y, size, align_corners=self.ppm_align_corners))
        y, ppm["out"] = self.cbr(p["ppm"]["out"], s["ppm"]["out"], torch.cat(feats, dim=-1))
        ns["ppm"] = ppm
        return y, ns

    def ffm(self, p, s, higher, lower):
        lower = resize_bilinear(lower, (higher.shape[1], higher.shape[2]), align_corners=True)
        lower, s_dw = self.cbr(p["dwconv"], s["dwconv"], lower, padding=1, groups=lower.shape[-1])
        lower = conv2d(lower, p["conv_lower_res"]["w"], p["conv_lower_res"]["b"])
        lower, s_lo = self.bn(p["conv_lower_res"]["bn"], s["conv_lower_res"]["bn"], lower)
        higher = conv2d(higher, p["conv_higher_res"]["w"], p["conv_higher_res"]["b"])
        higher, s_hi = self.bn(p["conv_higher_res"]["bn"], s["conv_higher_res"]["bn"], higher)
        return torch.relu(higher + lower), {
            "dwconv": s_dw, "conv_lower_res": {"bn": s_lo}, "conv_higher_res": {"bn": s_hi}}

    def classifier(self, p, s, x):
        y, s1 = self.ds(p["dsconv1"], s["dsconv1"], x)
        y, s2 = self.ds(p["dsconv2"], s["dsconv2"], y)
        y = self.dropout(y)
        return conv2d(y, p["conv"]["w"], p["conv"]["b"]), {"dsconv1": s1, "dsconv2": s2}

    def aux(self, p, s, x):
        y = conv2d(x, p["conv1"]["w"], padding=1)
        y, s_bn = self.bn(p["conv1"]["bn"], s["conv1"]["bn"], y)
        y = self.dropout(torch.relu(y))
        return conv2d(y, p["conv2"]["w"], p["conv2"]["b"]), {"conv1": {"bn": s_bn}}

    def dropout(self, x):
        """Inverted dropout, active only in training with a generator: keep
        each element with probability 1 − rate and scale it by 1/keep."""
        if not self.training or self.generator is None or self.dropout_rate <= 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def init_fast_scnn(num_classes: int, aux: bool = False, *, generator: torch.Generator,
                   device=None, **model_kwargs) -> FastSCNN:
    """A FastSCNN in eval mode, initialised from ``generator`` (a CPU
    ``torch.Generator``) with the PyTorch-default distributions: conv
    weights and biases U(±1/√fan_in) (kaiming-uniform with a=√5), BN
    scale 1, bias 0, running mean 0, running var 1. ``device=None`` means
    the CUDA card."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):  # module construction draws from the global RNG
        model = FastSCNN(num_classes, aux=aux, **model_kwargs)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
                bound = math.sqrt(1.0 / fan_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model.to(device).eval()


def _fold_tree(p, s):
    """Recursively fold {w[,b],bn} + state{bn} leaves into {w, b} (f32)."""
    if isinstance(p, list):
        return [_fold_tree(pi, si) for pi, si in zip(p, s)]
    if "w" in p and "bn" in p:
        bn, st = p["bn"], s["bn"]
        w, b = fold_conv_bn(p["w"], p.get("b"), bn["scale"], bn["bias"], st["mean"], st["var"])
        return {"w": w, "b": b}
    if "w" in p:  # plain conv (+bias), e.g. the classifier's last conv
        b = p["b"].float() if "b" in p else torch.zeros(p["w"].shape[-1], device=p["w"].device)
        return {"w": p["w"].float(), "b": b}
    return {k: _fold_tree(v, s.get(k, {})) for k, v in p.items()}


def fold_inference_params(module: FastSCNN, dtype=torch.bfloat16):
    """The BN-folded inference tree of ``module``: nested dicts (lists for
    the bottleneck stages) of HWIO ``{w, b}`` leaves in ``dtype``, on the
    module's device — the JAX package's ``fold_inference_params`` layout."""
    params, state = to_param_trees(module)
    folded = _fold_tree(params, state)
    return tree_map(lambda v: v.to(dtype).contiguous(), folded)
