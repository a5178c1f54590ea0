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
  ``'tapbwd'`` (:func:`~fastscnn_tpu_torch.ops.conv.conv2d_tapbwd`) or
  ``'pallas'`` (depthwise convs through kernel B6, the others through
  ``conv2d_tapbwd``). This is the graph the train and eval steps
  (``parallel/train.py``) differentiate and run.
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
from fastscnn_tpu_torch.ops.conv import (
    batch_norm_apply,
    batch_norm_train,
    conv2d,
    conv2d_tapbwd,
    fold_conv_bn,
)
from fastscnn_tpu_torch.ops.cuda.dw_conv import ds_conv3x3_pw, dw_conv3x3, dw_conv3x3_vjp
from fastscnn_tpu_torch.ops.pool import adaptive_avg_pool
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_matmul
from fastscnn_tpu_torch.utils.tree import tree_map

__all__ = ["FastSCNN", "init_fast_scnn", "fold_inference_params", "FOLDED_DW_IMPLS", "STEM_IMPLS"]

FOLDED_DW_IMPLS = ("conv", "pallas", "fused-ds")
STEM_IMPLS = ("xla", "tapbwd", "pallas")

# Options of the JAX model that this package does not run yet, with the
# ROADMAP.md queue item that ports each.
_NOT_PORTED = {
    "folded_dw_impl": {
        "taps": "queue item 'taps'",
        "fused-ds-mr": "kernel queue B5",
    },
    "stem_impl": {
        "taps": "queue item 'taps'",
        "taps-packbn": "queue item 'taps'",
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

    Besides the network it carries the JAX model's options
    ``folded_dw_impl`` ∈ :data:`FOLDED_DW_IMPLS` (serving), ``stem_impl``
    ∈ :data:`STEM_IMPLS` and ``dropout_rate`` (``apply_params``). The JAX
    options that are not ported yet (``folded_dw_impl`` 'taps' and
    'fused-ds-mr', ``folded_pw_impl`` other than 'conv',
    ``act_fake_quant``, ``stem_impl`` 'taps' and 'taps-packbn') raise
    ``NotImplementedError`` naming the ROADMAP.md item that ports them.
    The pyramid pooling keeps the training graph's bins (1, 2, 3, 6) and
    ``align_corners=True``; the JAX
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
        dropout_rate: float = 0.1,
    ):
        super().__init__()
        for option, value in (("folded_dw_impl", folded_dw_impl), ("stem_impl", stem_impl)):
            if value in _NOT_PORTED[option]:
                raise NotImplementedError(
                    f"{option}={value!r} is not ported yet "
                    f"(ROADMAP.md, {_NOT_PORTED[option][value]})"
                )
        if stem_impl not in STEM_IMPLS:
            raise ValueError(f"unknown stem_impl {stem_impl!r}")
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
        self.num_classes = num_classes
        self.aux = aux
        self.folded_dw_impl = folded_dw_impl
        self.stem_impl = stem_impl
        self.dropout_rate = dropout_rate
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


class _TreeForward:
    """The blocks of ``FastSCNN.apply_params``, each ``(p, s, x) -> (y,
    new_s)`` on NHWC activations — the JAX package's ``_apply_*`` and
    module functions."""

    def __init__(self, model: FastSCNN, training: bool, generator):
        self.training = training
        self.generator = generator
        self.dropout_rate = model.dropout_rate
        impl = model.stem_impl
        if impl == "xla":
            self.stem_conv = conv2d
        elif impl == "tapbwd":
            self.stem_conv = conv2d_tapbwd
        else:  # 'pallas': depthwise convs through kernel B6

            def stem_conv(x, w, stride=1, padding=0, groups=1):
                if groups > 1:
                    return dw_conv3x3_vjp(x, w, stride, padding)
                return conv2d_tapbwd(x, w, stride=stride, padding=padding, groups=groups)

            self.stem_conv = stem_conv

    def bn(self, p, s, x):
        if self.training:
            y, m, v = batch_norm_train(x, p["scale"], p["bias"], s["mean"], s["var"])
            return y, {"mean": m, "var": v}
        return batch_norm_apply(x, p["scale"], p["bias"], s["mean"], s["var"]), s

    def cbr(self, p, s, x, stride=1, padding=0, groups=1, relu=True, conv_fn=conv2d):
        y = conv_fn(x, p["w"], stride=stride, padding=padding, groups=groups)
        y, s_bn = self.bn(p["bn"], s["bn"], y)
        return (torch.relu(y) if relu else y), {"bn": s_bn}

    def ds(self, p, s, x, stride=1, conv_fn=conv2d):
        y, s_dw = self.cbr(p["dw"], s["dw"], x, stride=stride, padding=1, groups=x.shape[-1],
                           conv_fn=conv_fn)
        y, s_pw = self.cbr(p["pw"], s["pw"], y, conv_fn=conv_fn)
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
        conv = self.stem_conv
        y, s1 = self.cbr(p["conv"], s["conv"], x, stride=2, conv_fn=conv)
        y, s2 = self.ds(p["dsconv1"], s["dsconv1"], y, stride=2, conv_fn=conv)
        y, s3 = self.ds(p["dsconv2"], s["dsconv2"], y, stride=2, conv_fn=conv)
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
        for name, pool_size in zip(("conv1", "conv2", "conv3", "conv4"), _PPM_SIZES):
            y, ppm[name] = self.cbr(p["ppm"][name], s["ppm"][name], adaptive_avg_pool(x, pool_size))
            feats.append(resize_bilinear(y, size, align_corners=True))
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
