"""Fast-SCNN as a PyTorch module, plus the BN-folded serving graph.

Counterpart of ``fastscnn_tpu/models/fast_scnn.py``. The submodule names
are the reference ``state_dict`` keys (``models/convert.py::build_key_map``),
so a JAX-initialised model and a real ``fast_scnn_*.pth`` both load with
``strict=True``.

- ``FastSCNN.forward``: the unfolded eval-mode graph (the JAX ``apply``
  with ``training=False``). NHWC in and out; inside, NCHW tensors in
  ``channels_last`` memory, which are physically NHWC.
- :func:`fold_inference_params` and ``FastSCNN.apply_folded``: the
  serving graph on BN-folded HWIO ``{w, b}`` trees, with the LTD stem's
  depthwise convs routed by ``folded_dw_impl`` — ``'conv'`` (cuDNN),
  ``'pallas'`` (kernel B4, dw + bias + ReLU) or ``'fused-ds'`` (kernel B3,
  the whole DSConv). The JAX names are kept so configurations map one to
  one.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.models.convert import to_param_trees
from fastscnn_tpu_torch.ops.conv import conv2d, fold_conv_bn
from fastscnn_tpu_torch.ops.cuda.dw_conv import ds_conv3x3_pw, dw_conv3x3
from fastscnn_tpu_torch.ops.pool import adaptive_avg_pool
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_matmul

__all__ = ["FastSCNN", "init_fast_scnn", "fold_inference_params", "FOLDED_DW_IMPLS"]

FOLDED_DW_IMPLS = ("conv", "pallas", "fused-ds")

# Options of the JAX model that this package does not run yet, with the
# ROADMAP.md queue item that ports each.
_NOT_PORTED = {
    "folded_dw_impl": {
        "taps": "queue item 'taps'",
        "fused-ds-mr": "kernel queue B5",
    },
}


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

    def forward(self, x):
        size = (x.shape[2], x.shape[3])
        feats = [x]
        for conv, s in zip((self.conv1, self.conv2, self.conv3, self.conv4), _PPM_SIZES):
            y = conv(adaptive_avg_pool(x, s, h_axis=2, w_axis=3))
            feats.append(resize_bilinear(y, size, True, h_axis=2, w_axis=3))
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

    def forward(self, x):
        x = self.bottleneck3(self.bottleneck2(self.bottleneck1(x)))
        return self.ppm(x)


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

    Besides the network it carries the JAX model's serving option
    ``folded_dw_impl`` ∈ :data:`FOLDED_DW_IMPLS`. The JAX options that are
    not ported yet (``folded_dw_impl`` 'taps' and 'fused-ds-mr',
    ``folded_pw_impl`` other than 'conv', ``act_fake_quant``, and
    ``stem_impl`` other than 'xla') raise ``NotImplementedError`` naming
    the ROADMAP.md item that ports them. The pyramid pooling keeps the
    training graph's bins (1, 2, 3, 6) and ``align_corners=True``; the JAX
    deployment-graph knobs ``ppm_sizes``/``ppm_align_corners`` belong to
    the export surface.
    """

    def __init__(
        self,
        num_classes: int,
        aux: bool = False,
        folded_dw_impl: str = "conv",
        folded_pw_impl: str = "conv",
        act_fake_quant=None,
        stem_impl: str = "xla",
    ):
        super().__init__()
        if folded_dw_impl in _NOT_PORTED["folded_dw_impl"]:
            raise NotImplementedError(
                f"folded_dw_impl={folded_dw_impl!r} is not ported yet "
                f"(ROADMAP.md, {_NOT_PORTED['folded_dw_impl'][folded_dw_impl]})"
            )
        if folded_dw_impl not in FOLDED_DW_IMPLS:
            raise ValueError(f"unknown folded_dw_impl {folded_dw_impl!r}")
        if folded_pw_impl != "conv":
            raise NotImplementedError(
                f"folded_pw_impl={folded_pw_impl!r} is not ported yet "
                "(ROADMAP.md, queue item 'int8', kernels B7 and B8)"
            )
        if act_fake_quant is not None:
            raise NotImplementedError(
                "act_fake_quant is not ported yet (ROADMAP.md, queue item 'int8')"
            )
        if stem_impl != "xla":
            raise NotImplementedError(
                f"stem_impl={stem_impl!r} is not ported yet "
                "(ROADMAP.md, queue item 'slice 2: training', kernel B6)"
            )
        self.num_classes = num_classes
        self.aux = aux
        self.folded_dw_impl = folded_dw_impl
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

    def forward(self, x: torch.Tensor, upsample_outputs: bool = True):
        """NHWC input → tuple of NHWC logits, ``(main,)`` or ``(main, aux)``,
        at the input resolution (``upsample_outputs``) or at 1/8. Matches
        the JAX ``apply(training=False)`` in eval mode; training mode runs
        the reference's own BN and dropout semantics."""
        size = (x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)  # NHWC memory as a channels_last NCHW tensor
        higher = self.learning_to_downsample(x)
        lower = self.global_feature_extractor(higher)
        outs = [self.classifier(self.feature_fusion(higher, lower))]
        if self.aux:
            outs.append(self.auxlayer(higher))
        if upsample_outputs:
            outs = [resize_bilinear(o, size, True, h_axis=2, w_axis=3) for o in outs]
        return tuple(o.permute(0, 2, 3, 1) for o in outs)

    # -- folded inference ---------------------------------------------------
    def apply_folded(self, fparams, x: torch.Tensor, upsample_outputs: bool = True):
        """Inference forward on a BN-folded tree (:func:`fold_inference_params`):
        every block is conv + bias (+ ReLU). NHWC in, tuple of NHWC logits
        out; ``upsample_outputs=False`` returns 1/8-resolution logits so the
        caller picks the upsample formulation."""
        impl = self.folded_dw_impl

        def cbr(p, y, stride=1, padding=0, groups=1, relu=True):
            y = conv2d(y, p["w"], p["b"], stride=stride, padding=padding, groups=groups)
            return torch.relu(y) if relu else y

        def ds(p, y, stride=1, dw_alt=False):
            if dw_alt and impl == "fused-ds":
                # the whole DSConv in kernel B3: the dw activation never
                # reaches device memory
                return ds_conv3x3_pw(
                    y.contiguous(), p["dw"]["w"], p["dw"]["b"], p["pw"]["w"], p["pw"]["b"],
                    stride=stride, padding=1,
                )
            if dw_alt:  # 'pallas': dw + bias + ReLU in kernel B4
                y = dw_conv3x3(y.contiguous(), p["dw"]["w"], p["dw"]["b"], stride=stride,
                               padding=1, relu=True)
            else:
                y = cbr(p["dw"], y, stride=stride, padding=1, groups=y.shape[-1])
            return cbr(p["pw"], y)

        def bottleneck(p, y, stride):
            z = cbr(p["expand"], y)
            z = cbr(p["dw"], z, stride=stride, padding=1, groups=z.shape[-1])
            z = cbr(p["project"], z, relu=False)
            if stride == 1 and y.shape[-1] == z.shape[-1]:
                z = y + z
            return z

        size = (x.shape[1], x.shape[2])
        p = fparams
        dw_alt = impl != "conv"
        ltd = p["learning_to_downsample"]
        y = cbr(ltd["conv"], x, stride=2)
        y = ds(ltd["dsconv1"], y, stride=2, dw_alt=dw_alt)
        higher = ds(ltd["dsconv2"], y, stride=2, dw_alt=dw_alt)
        g = p["global_feature_extractor"]
        y = higher
        for name, stride in (("bottleneck1", 2), ("bottleneck2", 2), ("bottleneck3", 1)):
            for i, bp in enumerate(g[name]):
                y = bottleneck(bp, y, stride if i == 0 else 1)
        psize = (y.shape[1], y.shape[2])
        feats = [y]
        for conv_name, pool_size in zip(("conv1", "conv2", "conv3", "conv4"), _PPM_SIZES):
            z = cbr(g["ppm"][conv_name], adaptive_avg_pool(y, pool_size))
            feats.append(resize_bilinear_matmul(z, psize, align_corners=True))
        lower = cbr(g["ppm"]["out"], torch.cat(feats, dim=-1))
        f = p["feature_fusion"]
        lo = resize_bilinear_matmul(lower, (higher.shape[1], higher.shape[2]), align_corners=True)
        lo = cbr(f["dwconv"], lo, padding=1, groups=lo.shape[-1])
        lo = cbr(f["conv_lower_res"], lo, relu=False)
        hi = cbr(f["conv_higher_res"], higher, relu=False)
        fused = torch.relu(hi + lo)
        c = p["classifier"]
        y = ds(c["dsconv2"], ds(c["dsconv1"], fused))
        logits = conv2d(y, c["conv"]["w"], c["conv"]["b"])
        if upsample_outputs:
            logits = resize_bilinear_matmul(logits, size, align_corners=True)
        if self.aux and "auxlayer" in p:
            a = p["auxlayer"]
            z = cbr(a["conv1"], higher, padding=1)
            auxout = conv2d(z, a["conv2"]["w"], a["conv2"]["b"])
            if upsample_outputs:
                auxout = resize_bilinear_matmul(auxout, size, align_corners=True)
            return (logits, auxout)
        return (logits,)


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


def _map_tree(fn, tree):
    if isinstance(tree, list):
        return [_map_tree(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def fold_inference_params(module: FastSCNN, dtype=torch.bfloat16):
    """The BN-folded inference tree of ``module``: nested dicts (lists for
    the bottleneck stages) of HWIO ``{w, b}`` leaves in ``dtype``, on the
    module's device — the JAX package's ``fold_inference_params`` layout."""
    params, state = to_param_trees(module)
    folded = _fold_tree(params, state)
    return _map_tree(lambda v: v.to(dtype).contiguous(), folded)
