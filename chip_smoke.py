#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastscnn_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the ``nvcc`` build of every kernel source, from this checkout; then
   the depthwise forward and dW kernels on a sweep of small shapes, views
   and channel counts that runs every channel width they pick
   (:func:`dw_sweep`);
3. each kernel (B1-B5, B7, B8) at the shapes the 1024x2048 serving path
   gives it (N=1, bf16; B7 and B8 at every int8 site of a frame, and at one
   site with ``quantize_out``): held against its plain PyTorch version
   (B4 bit for bit in bf16 and f32, B5 also against B3's kernel), and timed
   with CUDA events beside the
   plain version and one PyTorch library call that computes the same
   function (a yardstick the port never calls), with its bound from the
   bytes it must move or its operations at the card's peak rate for
   their type;
4. serving: ``entry()`` on one frame; then the 19-class model with
   random weights from a fixed seed (BN statistics calibrated on one
   seeded batch, see :func:`calibrated_state`), BN-folded, in bf16,
   answering 4 requests of 2 uint8 1024x2048 frames (5 timed rounds) in
   config A (``fused-ds`` + ``pallas``: kernels B3, B1), config B
   (``pallas`` + ``hybrid-pallas``: kernels B4, B2) and the int8 configs,
   whose scales ``calibrate_pw_scales`` takes once on the kernel-free model
   over the calibration frames: C (``fused-ds-mr`` + ``int8-a8`` +
   ``pallas``: B5, B7, B1) and D (``pallas`` + ``int8-w8a8`` +
   ``hybrid-pallas``: B4, B8, B2); with the launch counters showing that
   each config ran its kernels, and the masks compared with the
   kernel-free config (``conv`` + ``hybrid``) and, for C and D, with the
   site-keyed fake-quant simulation of their int8 grid; then the first
   request again in f32, where the masks of A and B must agree with the
   kernel-free config, and a small f32 input through configs A to D on the
   card against the same configurations on the CPU;
5. kernel B6 (``dw_conv3x3_vjp``: forward through B4's kernel, dX and dW
   through the kernels of ``csrc/dw_conv_bwd.cu``) at the training stem's
   two depthwise sites (batch 16 of 768x768 crops, bf16), each part held
   against its plain version (the forward bit for bit in bf16 and f32; dW
   also run twice, bit-identical) and timed beside it, its byte bound and
   the cuDNN call that computes the same gradient;
6. training: the 19-class Cityscapes recipe (``stem_impl='pallas'``, aux
   head, mix OHEM CE, SGD with momentum and poly LR) at full width on
   16 uint8 768x768 crops whose labels are a seeded function of the
   image: one f32 step through ``'pallas'`` against one through ``'xla'``
   from the same weights; then bf16 steps on the fixed batch, whose
   losses must be finite and fall, with the B6 launch counters at 2 per
   step for each part; then ms/step, samples/s and peak device memory,
   and a ``torch.profiler`` breakdown of the step's device time;
7. one JSON line ``{"kernels": [...]}`` and, last, the device line
   ``{"ok": true, "device": {...}}``.

After phase 3 it also costs the depthwise forward and dW beside their
cuDNN calls three ways: device time, windows without the spin kernel
(which hold the host's time to issue the calls where that is longer) and
host us a call (:func:`dw_costs`). Two options run only the depthwise
kernels' studies, with no device line:

    python3 chip_smoke.py --tune-dw        # registers, launch-plan sweeps
    python3 chip_smoke.py --dw-ab PARENT   # dw_costs of the checkout at
                                           # PARENT and of this one

Without a CUDA device it prints an error and exits 1.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

SEED = 0
REQUESTS = 4
BATCH = 2
ROUNDS = 5  # timed repeats of the bf16 requests; the median is reported
HEIGHT, WIDTH = 1024, 2048
NUM_CLASSES = 19
# Published peaks (NVIDIA data sheets, SXM parts, dense): device-memory
# bytes/s, f32 FLOP/s outside the tensor cores, and the tensor cores' bf16
# FLOP/s and int8 OP/s, the least time a product in that type could take.
PEAKS = {
    "H200": {"bytes": 4.8e12, "f32": 67e12, "bf16": 989e12, "int8": 1979e12},
    "H100": {"bytes": 3.35e12, "f32": 67e12, "bf16": 989e12, "int8": 1979e12},
}
# training: the Cityscapes recipe's crops and batch; B6 at its two sites
# (name, N, H, W, C) at stride 2, after the stem conv's 768 -> 383
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS, TRAIN_LR = 16, 768, 20, 1e-2
# the recipe's poly schedule runs over 160 epochs of Cityscapes' 2975
# training images at batch 16; the smoke run takes its first steps
RECIPE_ITERS = 160 * (2975 // 16)
B6_SITES = (("dsconv1", 16, 383, 383, 32), ("dsconv2", 16, 192, 192, 48))
# 'pallas' vs 'xla' f32 step: within this factor of 'xla' f32 vs f64, or the floor
F32_STEP_FACTOR, F32_STEP_FLOOR = 4.0, 1e-4
# the operand type whose tensor-core peak bounds each int8 kernel's operations
INT8_PEAK = {"pw_conv_a8": "bf16", "pw_conv_w8a8": "int8"}
MASK_GATE = 0.995      # f32 serving masks vs the kernel-free config (PARITY.md's gate)
KERNEL_MASK_GATE = 0.999  # B1/B2 vs their plain versions; small f32 input vs the CPU
NEAR_TIE = 1e-5        # f32 gap below which a disagreeing pixel is a near-tie
SPIN_CYCLES = 20_000_000  # the spin kernel before each timing window (~10 ms on an H100)


def _print(*args):
    print(*args, flush=True)


def _windows(fn, iters, warmup, repeats, spin):
    """Medians over ``repeats`` windows of ``iters`` calls of ``fn``: the
    device ms a call (CUDA events) and the host us a call (the host clock
    around issuing the calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev, host = [], []
    for _ in range(repeats):
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / iters)
        host.append((t1 - t0) / iters * 1e6)
    return statistics.median(dev), statistics.median(host)


def time_ms(fn, iters=20, warmup=3, repeats=5, spin=True):
    """Device time of one ``fn`` call in ms: CUDA events around ``iters``
    calls, the median over ``repeats`` such windows. Each window is queued
    behind a spin kernel of about 10 ms, so the host has queued all its
    calls before the first starts: the window holds their device work back
    to back, not the host's time to issue them (a kernel wrapper's Python
    can take longer than a serving-size kernel runs). With ``spin=False``
    a window holds the longer of the two, as an eager caller sees it."""
    return _windows(fn, iters, warmup, repeats, spin)[0]


def call_costs(fn):
    """One call of ``fn`` three ways: ``device_ms`` (:func:`time_ms`),
    ``window_ms`` (the same windows without the spin: the longer of the
    device work and the host's time to issue it) and ``host_us`` (the host
    clock around issuing the calls of the spin windows, while the card is
    busy: the Python and the launches of one call)."""
    device_ms, host_us = _windows(fn, 20, 3, 5, True)
    return {"device_ms": device_ms, "window_ms": time_ms(fn, spin=False), "host_us": host_us}


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def dw_sweep():
    """The depthwise forward (B4 and B6's forward) and dW kernels on small
    shapes that make the wrappers pick every channel width VEC (C = 3, 6,
    8, 12, 32, 48 in bf16 and f32; C = 129, VEC 1, takes the forward's two
    channel groups of at most 128 vectors and five of dW's of 32), odd and
    even H and W, N = 1 and 3, strides 1 and 2, and on two views: a batch slice (which keeps its C's
    VEC) and a contiguous view one element into a flat buffer (VEC 1). The
    forward must equal its plain version bit for bit (with and without
    bias + ReLU), dW stay within 2e-5 of sum |x*g| in f32 and that plus one
    bf16 ulp in bf16."""
    import torch

    from fastscnn_tpu_torch.ops import cuda as K
    from fastscnn_tpu_torch.ops.cuda.dw_conv import vec_width

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases, vecs, worst = 0, set(), 0.0
    failures = []

    def check(label, x, w, b, gy, stride):
        nonlocal cases, worst
        relu = b is not None
        got = K.dw_conv3x3(x, w, b, stride, 1, relu)
        ref = K.dw_conv3x3_reference(x, w, b, stride, 1, relu)
        if not torch.equal(got, ref):
            failures.append(f"{label}: forward, {int((got != ref).sum())} elements differ")
        dw = K.dw_conv3x3_dw(x, gy, stride, 1, torch.float32)
        dw_ref = K.dw_conv3x3_dw_reference(x, gy, stride, 1)
        scale = K.dw_conv3x3_dw_reference(x.abs(), gy.abs(), stride, 1).clamp_min(1e-30)
        e32 = ((dw - dw_ref).abs() / scale).max().item()
        dw16 = K.dw_conv3x3_dw(x, gy, stride, 1, torch.bfloat16).float()
        ref16 = dw_ref.to(torch.bfloat16).float()
        bad16 = int(((dw16 - ref16).abs() > ref16.abs() * 2.0**-7 + 2e-5 * scale).sum())
        if e32 > 2e-5 or bad16:
            failures.append(f"{label}: dW f32 error {e32:.3g} of sum|x*g|, {bad16} bf16 beyond")
        worst = max(worst, e32)
        vecs.add((str(x.dtype).split(".")[-1],
                  vec_width(x.shape[-1], x.element_size(), (x.data_ptr(), got.data_ptr()))))
        cases += 1

    for dtype in (torch.bfloat16, torch.float32):
        for c in (3, 6, 8, 12, 32, 48, 129):
            for n, h, w in ((1, 17, 23), (3, 16, 22), (3, 9, 8)):
                for stride in (1, 2):
                    x = torch.randn((n, h, w, c), generator=g, device=dev).to(dtype)
                    wt = torch.randn((3, 3, 1, c), generator=g, device=dev) * 0.3
                    b = torch.randn((c,), generator=g, device=dev) * 0.1 if n == 3 else None
                    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
                    gy = torch.randn((n, ho, wo, c), generator=g, device=dev).to(dtype)
                    check(f"{dtype} {tuple(x.shape)} stride {stride}", x, wt, b, gy, stride)
        # views: a batch slice, and one element into a flat buffer
        def view_of(shape, view):
            if view == "batch slice":
                return torch.randn((shape[0] + 1, *shape[1:]), generator=g, device=dev).to(dtype)[1:]
            flat = torch.randn(math.prod(shape) + 1, generator=g, device=dev).to(dtype)
            return flat[1:].view(shape)

        for c, view in ((6, "batch slice"), (32, "flat offset"), (48, "flat offset")):
            x = view_of((3, 15, 13, c), view)
            wt = torch.randn((3, 3, 1, c), generator=g, device=dev) * 0.3
            for stride in (1, 2):
                gy = view_of((3, (15 - 1) // stride + 1, (13 - 1) // stride + 1, c), view)
                check(f"{dtype} {view} {tuple(x.shape)} stride {stride}", x, wt, None, gy, stride)
    torch.cuda.synchronize()
    _print(f"  depthwise sweep: {cases} cases, forward bit-equal and dW within tolerance in "
           f"{cases - len(failures)}; channel widths (dtype, VEC) {sorted(vecs)}; worst dW f32 "
           f"error {worst:.3g} of sum|x*g|")
    if failures:
        raise AssertionError("depthwise sweep: " + "; ".join(failures[:10]))


def kernel_phase(peaks):
    """Phases 3 and 5: each kernel against its plain version at its path's
    shapes, with times, bounds and the library yardstick."""
    import torch
    import torch.nn.functional as F

    from fastscnn_tpu_torch.ops import cuda as K
    from fastscnn_tpu_torch.ops.resize import resize_bilinear

    bw, flops = peaks["bytes"], peaks["f32"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(nb, nops, peak=flops):
        t_bytes, t_ops = nb / bw * 1e3, nops / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def close_bf16(name, got, ref):
        # Kernel and plain version do the same f32 operations in the same
        # order, so they should agree bit for bit; the check allows one
        # bf16 ulp (2^-7 relative) for a rounding-order slip.
        err = (got.float() - ref.float()).abs()
        limit = ref.float().abs() * 2.0**-7 + 2.0**-10
        bad = int((err > limit).sum())
        _print(f"  {name}: max_abs_err {err.max().item():.3g}, "
               f"{int((err > 0).sum())} of {err.numel()} elements differ, {bad} beyond 1 bf16 ulp")
        if bad:
            raise AssertionError(f"{name}: {bad} elements beyond tolerance")
        return err.max().item()

    def vs_f32(name, got, lib_out, exact):
        """Reported, not gated: the kernel's and the bf16 library call's
        distance from the same function computed by cuDNN in f32 on the
        same bf16 inputs (``exact``)."""
        ek = (got.float() - exact).abs()
        el = (lib_out.float() - exact).abs()
        _print(f"  {name} vs cuDNN in f32: kernel max |err| {ek.max().item():.4g} "
               f"(mean {ek.mean().item():.3g}); bf16 library max |err| {el.max().item():.4g} "
               f"(mean {el.mean().item():.3g}); output max |value| {exact.abs().max().item():.4g}")

    def mask_agree(name, got, ref, z):
        """Masks from a kernel and its plain version; ``z`` the plain f32
        interpolated logits, (..., C). Disagreements must be near-ties."""
        diff = got != ref
        agree = 1.0 - diff.float().mean().item()
        zk = z.gather(-1, got.long().unsqueeze(-1))
        zp = z.gather(-1, ref.long().unsqueeze(-1))
        gap = (zk - zp).abs().max().item()
        _print(f"  {name}: mask agreement {agree:.6f} ({int(diff.sum())} pixels differ), "
               f"max f32 gap at a differing pixel {gap:.3g}")
        if agree < KERNEL_MASK_GATE or gap > NEAR_TIE:
            raise AssertionError(f"{name}: agreement {agree} / gap {gap} outside the gate")
        return gap

    results = []

    # B3, B4 and B5 at the LTD's two stride-2 sites: dsconv1 (32 -> 48) on
    # the stem conv's 511x1023 output, dsconv2 (48 -> 64) on 256x512. B5
    # computes B3's function (rows_per_step 8): it must equal B3's plain
    # version and B3's kernel bit for bit.
    sites = (("dsconv1", 511, 1023, 32, 48), ("dsconv2", 256, 512, 48, 64))
    for kname, plain, src, replaces in (
        ("ds_conv3x3_pw", K.ds_conv3x3_pw_reference, "fastscnn_tpu_torch/csrc/dw_conv.cu",
         "fastscnn_tpu/ops/pallas/dw_conv.py:195"),
        ("dw_conv3x3", K.dw_conv3x3_reference, "fastscnn_tpu_torch/csrc/dw_conv.cu",
         "fastscnn_tpu/ops/pallas/dw_conv.py:124"),
        ("ds_conv3x3_pw_multirow", K.ds_conv3x3_pw_reference,
         "fastscnn_tpu_torch/csrc/ds_conv_mr.cu", "fastscnn_tpu/ops/pallas/dw_conv.py:286"),
    ):
        kern = K.KERNELS[kname]
        entry = {"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                 "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "library_ms": 0.0, "sites": []}
        for site, h, w, c, cout in sites:
            x = randn(1, h, w, c).clamp_min(0)  # post-ReLU activations
            w_dw, b_dw = randn(3, 3, 1, c, scale=0.3), randn(c, scale=0.1)
            w_pw, b_pw = randn(1, 1, c, cout, scale=0.2), randn(cout, scale=0.1)
            xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view for cuDNN
            wdw_oihw = w_dw.permute(3, 2, 0, 1).contiguous()
            wpw_oihw = w_pw.permute(3, 2, 0, 1).contiguous()
            ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
            if kname != "dw_conv3x3":
                args = (x, w_dw, b_dw, w_pw, b_pw, 2, 1)

                def lib(dt=bf16):
                    mid = F.relu(F.conv2d(xc.to(dt), wdw_oihw.to(dt), b_dw.to(dt), stride=2,
                                          padding=1, groups=c))
                    mid = mid.to(bf16).to(dt)  # the dw activation rounds to bf16 by design
                    return F.relu(F.conv2d(mid, wpw_oihw.to(dt), b_pw.to(dt)))

                out_bytes = ho * wo * cout * 2
                ops = 2 * ho * wo * c * (9 + cout)
                w_bytes = nbytes(w_dw, b_dw, w_pw, b_pw)
            else:
                args = (x, w_dw, b_dw, 2, 1, True)

                def lib(dt=bf16):
                    return F.relu(F.conv2d(xc.to(dt), wdw_oihw.to(dt), b_dw.to(dt), stride=2,
                                           padding=1, groups=c))

                out_bytes = ho * wo * c * 2
                ops = 2 * ho * wo * c * 9
                w_bytes = nbytes(w_dw, b_dw)
            got = kern(*args)
            torch.cuda.synchronize()
            err = close_bf16(f"{kname}[{site}] {tuple(x.shape)} -> {tuple(got.shape)}",
                             got, plain(*args))
            if kname == "ds_conv3x3_pw_multirow":
                b3 = K.ds_conv3x3_pw(*args)
                same = torch.equal(got, b3)
                _print(f"  {kname}[{site}] vs B3's kernel: "
                       f"{'bit-equal' if same else 'DIFFERENT'} ({int((got != b3).sum())} differ)")
                if err or not same:
                    raise AssertionError(f"{kname}[{site}]: not bit-equal to B3")
            if kname == "dw_conv3x3":  # bit for bit, in bf16 and in f32
                a32 = (x.float(), *args[1:])
                diff32 = int((kern(*a32) != plain(*a32)).sum())
                _print(f"  {kname}[{site}] in f32: {diff32} elements differ from the plain version")
                if err or diff32:
                    raise AssertionError(f"{kname}[{site}]: not bit-equal to its plain version")
            vs_f32(f"{kname}[{site}]", got, lib().permute(0, 2, 3, 1),
                   lib(torch.float32).permute(0, 2, 3, 1))
            ms = time_ms(lambda: kern(*args))
            plain_ms = time_ms(lambda: plain(*args), iters=5, warmup=1, repeats=3)
            lib_ms = time_ms(lib)
            b_ms, b_by = bound(nbytes(x) + w_bytes + out_bytes, ops)
            _print(f"  {kname}[{site}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                   f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            entry["sites"].append({"site": site, "ms": ms, "plain_ms": plain_ms,
                                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                                   "max_abs_err": err})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                           ("library_ms", lib_ms)):
                entry[key] += v
            entry["bound_by"] = b_by
        results.append(entry)

    # B1: (1, 128, 256, 19) NHWC logits -> (1, 1024, 2048) mask.
    h, w = HEIGHT // 8, WIDTH // 8
    logits = randn(1, h, w, NUM_CLASSES)
    got = K.upsample_argmax(logits, (HEIGHT, WIDTH))
    torch.cuda.synchronize()
    ref = K.upsample_argmax_reference(logits, (HEIGHT, WIDTH))
    z = resize_bilinear(logits.float(), (HEIGHT, WIDTH))
    gap = mask_agree("upsample_argmax (1, 128, 256, 19) -> (1, 1024, 2048)", got, ref, z)
    del z
    lc = logits.permute(0, 3, 1, 2)
    for dt in (bf16, torch.float32):
        lib_mask = F.interpolate(lc.to(dt), size=(HEIGHT, WIDTH), mode="bilinear",
                                 align_corners=True).argmax(1)
        _print(f"  upsample_argmax vs library ({dt} interpolate + argmax): mask agreement "
               f"{(lib_mask == got).float().mean().item():.6f}")
    ms = time_ms(lambda: K.upsample_argmax(logits, (HEIGHT, WIDTH)))
    plain_ms = time_ms(lambda: K.upsample_argmax_reference(logits, (HEIGHT, WIDTH)), iters=5,
                       repeats=3)
    lib_ms = time_ms(lambda: F.interpolate(lc, size=(HEIGHT, WIDTH), mode="bilinear",
                                           align_corners=True).argmax(1))
    ops = 3 * NUM_CLASSES * HEIGHT * WIDTH + 3 * w * NUM_CLASSES * HEIGHT
    b_ms, b_by = bound(nbytes(logits) + HEIGHT * WIDTH * 4, ops)
    _print(f"  upsample_argmax: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
           f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results.append({"name": "upsample_argmax", "route": "cuda",
                    "source": "fastscnn_tpu_torch/csrc/upsample_argmax.cu",
                    "replaces": "fastscnn_tpu/ops/pallas/upsample_argmax.py:100",
                    "max_abs_err": gap, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms})

    # B2: (1, 128, 19, 2048) W-upsampled logits -> (1, 1024, 2048) mask.
    xw = randn(1, h, NUM_CLASSES, WIDTH)
    got = K.h_lerp_argmax(xw, HEIGHT)
    torch.cuda.synchronize()
    ref = K.h_lerp_argmax_reference(xw, HEIGHT)
    z = resize_bilinear(xw.float(), (HEIGHT, WIDTH), h_axis=1, w_axis=3).permute(0, 1, 3, 2)
    gap = mask_agree("h_lerp_argmax (1, 128, 19, 2048) -> (1, 1024, 2048)", got, ref, z)
    del z
    xwc = xw.permute(0, 2, 1, 3)
    for dt in (bf16, torch.float32):
        lib_mask = F.interpolate(xwc.to(dt), size=(HEIGHT, WIDTH), mode="bilinear",
                                 align_corners=True).argmax(1)
        _print(f"  h_lerp_argmax vs library ({dt} interpolate + argmax): mask agreement "
               f"{(lib_mask == got).float().mean().item():.6f}")
    ms = time_ms(lambda: K.h_lerp_argmax(xw, HEIGHT))
    plain_ms = time_ms(lambda: K.h_lerp_argmax_reference(xw, HEIGHT), iters=5, repeats=3)
    lib_ms = time_ms(lambda: F.interpolate(xwc, size=(HEIGHT, WIDTH), mode="bilinear",
                                           align_corners=True).argmax(1))
    b_ms, b_by = bound(nbytes(xw) + HEIGHT * WIDTH * 4, 3 * NUM_CLASSES * HEIGHT * WIDTH)
    _print(f"  h_lerp_argmax: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
           f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results.append({"name": "h_lerp_argmax", "route": "cuda",
                    "source": "fastscnn_tpu_torch/csrc/upsample_argmax.cu",
                    "replaces": "fastscnn_tpu/ops/pallas/upsample_argmax.py:240",
                    "max_abs_err": gap, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms})

    # B6 at the training stem's two depthwise sites, bf16: forward (B4's
    # kernel, no bias or ReLU), dX and dW, each against its plain version
    # and, reported, against cuDNN computing the same function in f32.
    from torch.nn.grad import conv2d_input, conv2d_weight

    parts = {}
    for part, src in (("forward", "dw_conv.cu"), ("dx", "dw_conv_bwd.cu"),
                      ("dw", "dw_conv_bwd.cu")):
        parts[part] = {"name": f"dw_conv3x3_vjp:{part}", "route": "cuda",
                       "source": f"fastscnn_tpu_torch/csrc/{src}",
                       "replaces": "fastscnn_tpu/ops/pallas/dw_conv.py:457",
                       "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                       "library_ms": 0.0, "sites": []}
    for site, n, h, w, c in B6_SITES:
        ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        x = randn(n, h, w, c).clamp_min(0)  # post-ReLU activations
        wt = randn(3, 3, 1, c, scale=0.3)
        gy = randn(n, ho, wo, c, scale=0.01)
        xc, gc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)  # channels_last views
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        nchw = (n, c, h, w)
        ops = 2 * 9 * n * ho * wo * c
        calls = {
            "forward": (lambda: K.dw_conv3x3(x, wt, None, 2, 1),
                        lambda: K.dw_conv3x3_reference(x, wt, None, 2, 1),
                        lambda dt=bf16: F.conv2d(xc.to(dt), w_oihw.to(dt), stride=2, padding=1,
                                                 groups=c).permute(0, 2, 3, 1),
                        nbytes(x, wt) + n * ho * wo * c * 2),
            "dx": (lambda: K.dw_conv3x3_dx(gy, wt, 2, 1, x.shape),
                   lambda: K.dw_conv3x3_dx_reference(gy, wt, 2, 1, x.shape),
                   lambda dt=bf16: conv2d_input(nchw, w_oihw.to(dt), gc.to(dt), stride=2,
                                                padding=1, groups=c).permute(0, 2, 3, 1),
                   nbytes(gy, wt, x)),  # dX has the size of x
            "dw": (lambda: K.dw_conv3x3_dw(x, gy, 2, 1, bf16),
                   lambda: K.dw_conv3x3_dw_reference(x, gy, 2, 1, bf16),
                   lambda dt=bf16: conv2d_weight(xc.to(dt), (c, 1, 3, 3), gc.to(dt), stride=2,
                                                 padding=1, groups=c).permute(2, 3, 1, 0),
                   nbytes(x, gy) + 9 * c * 2),
        }
        for part, (kern, plain, lib, moved) in calls.items():
            got = kern()
            torch.cuda.synchronize()
            label = f"dw_conv3x3_vjp:{part}[{site}]"
            if part != "dw":
                err = close_bf16(f"{label} x {tuple(x.shape)}", got, plain())
                if part == "forward":  # bit for bit, in bf16 and in f32
                    x32 = x.float()
                    diff32 = int((K.dw_conv3x3(x32, wt, None, 2, 1)
                                  != K.dw_conv3x3_reference(x32, wt, None, 2, 1)).sum())
                    del x32
                    _print(f"  {label} in f32: {diff32} elements differ from the plain version")
                    if err or diff32:
                        raise AssertionError(f"{label}: not bit-equal to its plain version")
            else:
                # dW sums n*ho*wo products per (tap, c) in another order than
                # the plain version's reductions: f32 reassociation, bounded
                # by 2e-5 of the sum of |x*g| (both orders), plus one bf16
                # ulp where the two f32 sums round to neighbouring bf16s
                ref = plain().float()
                scale = K.dw_conv3x3_dw_reference(x.abs(), gy.abs(), 2, 1).float()
                f32 = K.dw_conv3x3_dw(x, gy, 2, 1, torch.float32)
                f32_ref = K.dw_conv3x3_dw_reference(x, gy, 2, 1)
                e32 = ((f32 - f32_ref).abs() / scale.clamp_min(1e-30)).max().item()
                errv = (got.float() - ref).abs()
                bad = int((errv > ref.abs() * 2.0**-7 + 2e-5 * scale).sum())
                err = errv.max().item()
                # a fixed summation order: a second run gives the same bits
                again = (torch.equal(got, kern())
                         and torch.equal(f32, K.dw_conv3x3_dw(x, gy, 2, 1, torch.float32)))
                _print(f"  {label}: f32 max |err| / sum|x*g| {e32:.3g} (gate 2e-5); bf16 "
                       f"max_abs_err {err:.3g}, {bad} of {errv.numel()} beyond 1 ulp + 2e-5 sum; "
                       f"second run {'bit-identical' if again else 'DIFFERENT'}")
                if e32 > 2e-5 or bad or not again:
                    raise AssertionError(f"{label}: outside tolerance or not reproducible")
            vs_f32(label, got, lib(), lib(torch.float32).float())
            ms = time_ms(kern)
            plain_ms = time_ms(plain, iters=3, warmup=1, repeats=3)
            lib_ms = time_ms(lib)
            b_ms, b_by = bound(moved, ops)
            _print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                   f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB)")
            entry = parts[part]
            entry["sites"].append({"site": site, "ms": ms, "plain_ms": plain_ms,
                                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                                   "max_abs_err": err})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                           ("library_ms", lib_ms)):
                entry[key] += v
            entry["bound_by"] = b_by
        del x, gy, xc, gc, calls
        torch.cuda.empty_cache()
    results.extend(parts.values())
    results.extend(int8_kernel_phase(peaks, bound, nbytes, g))
    return results


def int8_sites(dev):
    """The int8 sites of one 1024x2048 frame as (site, M, K, N, relu),
    read from the serving graph itself: the kernel-free model's conv
    inputs, recorded by its ``act_fake_quant`` hook, at the sites of
    ``PW_INT8_SITES``. A bottleneck's project and the FFM's two 1x1s have
    no ReLU."""
    import torch

    from fastscnn_tpu_torch.models import PW_INT8_SITES, fold_inference_params, init_fast_scnn

    model = init_fast_scnn(NUM_CLASSES, generator=torch.Generator().manual_seed(SEED), device=dev)
    folded = fold_inference_params(model)
    seen = {}

    def record(y, site=None):
        if site in PW_INT8_SITES:
            seen[site] = (y.numel() // y.shape[-1], y.shape[-1])
        return y

    with torch.inference_mode():
        model.with_options(act_fake_quant=record).apply_folded(
            folded, torch.zeros((1, HEIGHT, WIDTH, 3), dtype=torch.bfloat16, device=dev),
            upsample_outputs=False)

    top = {"ltd": "learning_to_downsample", "gfe": "global_feature_extractor",
           "ffm": "feature_fusion", "cls": "classifier"}

    def cout(site):  # the site's 1x1 weight in the folded tree, (1, 1, K, N)
        head, *rest = site.split("/")
        p = folded[top[head]]
        for part in rest:
            p = p[int(part)] if part.isdigit() else p[part]
        return p["w"].shape[-1]

    return [(site, m, k, cout(site), not (site.endswith("project") or site.startswith("ffm/")))
            for site, (m, k) in ((s, seen[s]) for s in PW_INT8_SITES)]


def int8_kernel_phase(peaks, bound, nbytes, g):
    """B7 and B8 at every int8 site of a frame (N=1), each held against its
    plain version (B8 bit-equal; B7 bit-equal expected, within one bf16 ulp
    or one int8 level allowed), and at one site with ``quantize_out``.
    Times and bounds are summed over the sites of the config that runs the
    kernel (B7: the 23 sites of config C, whose LTD 1x1s run inside B5; B8:
    all 25, config D). Bound: bytes, or operations at the tensor-core
    peak of the operand type (bf16 for B7, int8 for B8). Yardsticks, never
    on the path: ``torch.addmm`` in bf16 on the dequantized input (B7) and
    ``torch._int_mm`` (B8), each with the epilogue."""
    import torch

    from fastscnn_tpu_torch.ops import cuda as K

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    sites = int8_sites(dev)
    q_site = "gfe/bottleneck1/1/expand"  # the quantize_out check
    entries = {}
    for kname, src_line in (("pw_conv_a8", "fastscnn_tpu/ops/pallas/int8_pw.py:144"),
                            ("pw_conv_w8a8", "fastscnn_tpu/ops/pallas/int8_pw.py:197")):
        entries[kname] = {"name": kname, "route": "cuda",
                          "source": "fastscnn_tpu_torch/csrc/int8_pw.cu", "replaces": src_line,
                          "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                          "library_ms": 0.0, "bound_by": "", "sites": []}
    for site, m, k, n, relu in sites:
        x_q = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w_eff = (torch.randn((k, n), generator=g, device=dev) * (0.5 / k**0.5)).to(bf16)
        w_q = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        cs = torch.rand(n, generator=g, device=dev) * (1.0 / (73.0 * k**0.5))
        b = torch.randn(n, generator=g, device=dev) * 5.0
        b16 = b.to(bf16)
        for qout in ((False, True) if site == q_site else (False,)):
            out_bytes = m * n * (1 if qout else 2)

            def epilogue(t):
                t = torch.relu(t) if relu else t
                return t.round().clamp(-127, 127).to(torch.int8) if qout else t.to(bf16)

            calls = {
                "pw_conv_a8": (
                    lambda: K.pw_conv_a8(x_q, w_eff, b, relu, qout),
                    lambda: K.pw_conv_a8_reference(x_q, w_eff, b, relu, qout),
                    lambda: epilogue(torch.addmm(b16, x_q.to(bf16), w_eff)),
                    nbytes(x_q, w_eff, b) + out_bytes),
                "pw_conv_w8a8": (
                    lambda: K.pw_conv_w8a8(x_q, w_q, cs, b, relu, qout),
                    lambda: K.pw_conv_w8a8_reference(x_q, w_q, cs, b, relu, qout),
                    lambda: epilogue(torch._int_mm(x_q, w_q) * cs + b),
                    nbytes(x_q, w_q, cs, b) + out_bytes),
            }
            for kname, (kern, plain, lib, moved) in calls.items():
                entry = entries[kname]
                label = f"{kname}[{site}{', quantize_out' if qout else ''}] ({m}x{k})x({k}x{n})"
                got = kern()
                torch.cuda.synchronize()
                ref = plain()
                diff = (got.float() - ref.float()).abs()
                err, ndiff = diff.max().item(), int((diff > 0).sum())
                if qout:
                    bad = int((diff > 1).sum())
                else:
                    bad = int((diff > ref.float().abs() * 2.0**-7 + 1e-30).sum())
                _print(f"  {label}: max_abs_err {err:.3g}, {ndiff} of {diff.numel()} differ, "
                       f"{bad} beyond {'one int8 level' if qout else '1 bf16 ulp'}")
                if bad or (kname == "pw_conv_w8a8" and ndiff):
                    raise AssertionError(f"{label}: outside tolerance")
                lib_err = (lib().float() - ref.float()).abs().max().item()
                ms = time_ms(kern)
                plain_ms = time_ms(plain, iters=2, warmup=1, repeats=3)
                lib_ms = time_ms(lib)
                b_ms, b_by = bound(moved, 2 * m * k * n, peaks[INT8_PEAK[kname]])
                _print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                       f"{lib_ms:.4f} ms (max |diff| from plain {lib_err:.3g}), bound "
                       f"{b_ms:.4f} ms ({b_by})")
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                rec = {"site": site, "quantize_out": qout, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "max_abs_err": err}
                entry["sites"].append(rec)
                # the frame's sum: config C's 23 sites for B7, D's 25 for B8
                if not qout and (kname == "pw_conv_w8a8" or not site.startswith("ltd/")):
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                        entry[key] += rec[key]
                    entry["bound_by"] = b_by
        del x_q, w_eff, w_q
    for entry in entries.values():
        _print(f"  {entry['name']} over a frame's sites: kernel {entry['ms']:.4f} ms, plain "
               f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']:.4f} ms, bound "
               f"{entry['bound_ms']:.4f} ms")
    return list(entries.values())



def calibrated_state(frames):
    """Random weights from SEED, with BN running statistics taken from
    ``frames`` (one train-mode pass, cumulative average). With the
    default statistics (mean 0, var 1) a random network's activations
    shrink layer by layer until the classifier bias alone picks the
    class: the mask is one class everywhere and every comparison of
    masks passes trivially. Calibrated statistics normalise each layer as
    training would, so the mask has many classes and real boundaries."""
    import torch

    from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD
    from fastscnn_tpu_torch.models import init_fast_scnn

    model = init_fast_scnn(NUM_CLASSES, generator=torch.Generator().manual_seed(SEED),
                           device=frames.device)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    model.train()
    with torch.no_grad():
        model((frames.float() / 255.0 - mean) / std)
    for bn in bns:
        bn.momentum = 0.1
    return model.eval().state_dict()


def serving_phase():
    """Phase 4: the port's serving path through its entry points.
    Returns {kernel name: launches in the run of the config that uses it}."""
    import torch

    from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.entry import entry
    from fastscnn_tpu_torch.models import FastSCNN, calibrate_pw_scales, quantized_model
    from fastscnn_tpu_torch.ops.cuda import launch_counts, quantize_act, reset_launch_counts
    from fastscnn_tpu_torch.ops.resize import resize_bilinear

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def frames(n):
        return torch.randint(0, 256, (n, HEIGHT, WIDTH, 3), generator=g, device=dev,
                             dtype=torch.uint8)

    # the entry point, as a user would call it: one (1, 1024, 2048) frame
    # through kernels B3 (twice) and B1 (once)
    predict, (example,) = entry()
    predict(example)
    reset_launch_counts()
    mask = predict(frames(1))
    torch.cuda.synchronize()
    counts = launch_counts()
    _print(f"entry(): mask {tuple(mask.shape)} {mask.dtype}, launches {counts}")
    want = {name: 0 for name in counts} | {"upsample_argmax": 1, "ds_conv3x3_pw": 2}
    if mask.shape != (1, HEIGHT, WIDTH) or mask.dtype != torch.int32 or counts != want:
        raise AssertionError("entry() did not serve its frame through B3 and B1")

    calib = frames(BATCH)
    state = calibrated_state(calib)

    def engine(impl, mode, dtype, device=dev, pw="conv", hook=None):
        model = FastSCNN(NUM_CLASSES, folded_dw_impl=impl, act_fake_quant=hook)
        model.load_state_dict(state)
        if pw != "conv":
            model = quantized_model(model, scales, pw)
        return InferenceEngine(model, device=device, config=E2EConfig(
            mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype=dtype, final_upsample=mode))

    # int8 scales: once, on the kernel-free model in the serving dtype, over
    # the calibration frames, normalised as the engine does
    cal = engine("conv", "hybrid", "bfloat16")
    scales = calibrate_pw_scales(cal.model, cal.folded, [calib], preprocess=cal._preprocess)
    del cal
    scale_of = dict(scales)
    _print(f"int8 scales of {len(scales)} sites: "
           f"{min(v for _, v in scales):.4g} to {max(v for _, v in scales):.4g}")

    class SiteFakeQuant:
        """The int8 value grid at the calibrated sites, simulated in the
        compute dtype on the kernel-free 1x1s (quantize, dequantize)."""

        def __call__(self, y, site=None):
            s = scale_of.get(site)
            if s is None:
                return y
            return (quantize_act(y, s).float() * torch.tensor(s, device=y.device)).to(y.dtype)

    batches = [frames(BATCH) for _ in range(REQUESTS)]
    configs = (  # label, folded_dw_impl, folded_pw_impl, final_upsample, launches per request
        ("ref", "conv", "conv", "hybrid", {}),
        ("A", "fused-ds", "conv", "pallas", {"ds_conv3x3_pw": 2, "upsample_argmax": 1}),
        ("B", "pallas", "conv", "hybrid-pallas", {"dw_conv3x3": 2, "h_lerp_argmax": 1}),
        ("C", "fused-ds-mr", "int8-a8", "pallas",
         {"ds_conv3x3_pw_multirow": 2, "pw_conv_a8": 23, "upsample_argmax": 1}),
        ("D", "pallas", "int8-w8a8", "hybrid-pallas",
         {"dw_conv3x3": 2, "pw_conv_w8a8": 25, "h_lerp_argmax": 1}),
    )
    launches, failures = {}, []
    # bf16 is the serving configuration: timed, launch counts gated, its
    # agreement with ref reported. f32 repeats the first request: there the
    # formulations A and B differ by f32 rounding only, so their masks carry
    # the agreement gate (see PERF.md on why bf16 cannot on random weights);
    # C and D change the result by design (int8), so theirs are reported,
    # beside their agreement with the fake-quant simulation of their grid.
    for dtype, reqs, rounds in (("bfloat16", batches, ROUNDS), ("float32", batches[:1], 1)):
        ref = None
        for label, impl, pw, mode, per_request in configs:
            eng = engine(impl, mode, dtype, pw=pw)
            eng.predict(reqs[0])  # first call: cuDNN plans, kernel build and load
            torch.cuda.synchronize()
            reset_launch_counts()
            times = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                masks = [eng.predict(b) for b in reqs]
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / (len(reqs) * BATCH))
            counts = launch_counts()
            ms, ms_min = statistics.median(times), min(times)
            masks = torch.stack(masks)
            if masks.shape != (len(reqs), BATCH, HEIGHT, WIDTH) or masks.dtype != torch.int32:
                raise AssertionError(f"config {label}: masks {tuple(masks.shape)} {masks.dtype}")
            hist = torch.bincount(masks.flatten().long(), minlength=NUM_CLASSES)
            if hist.numel() != NUM_CLASSES or int(masks.min()) < 0:
                raise AssertionError(f"config {label}: class ids outside [0, {NUM_CLASSES})")
            _print(f"serving {dtype} config {label} ({impl} + {pw} + {mode}): {ms:.3f} ms/frame "
                   f"median, {ms_min:.3f} min (host clock, {rounds} rounds of {len(reqs)} "
                   f"requests x {BATCH} frames), launches {counts}, "
                   f"{int((hist > 0).sum())} classes present, largest class "
                   f"{hist.max().item() / masks.numel():.3f} of pixels")
            want = {name: per_request.get(name, 0) * len(reqs) * rounds for name in counts}
            if counts != want:
                failures.append(f"{dtype} config {label}: launches {counts}, expected {want}")
            if dtype == "bfloat16":
                launches.update({k: v for k, v in want.items() if v})
            with torch.inference_mode():
                logits = eng._forward(reqs[0], upsample=False).float()
            del eng
            if ref is None:
                ref = (masks, logits)
                continue
            agree = (masks == ref[0]).float().mean().item()
            # where the masks differ, how far apart are the two classes in
            # the reference's logits, interpolated exactly (f32)?
            diff = masks[0] != ref[0][0]
            with torch.inference_mode():
                z = resize_bilinear(ref[1], (HEIGHT, WIDTH))
            za = z.gather(-1, masks[0].long().unsqueeze(-1))[..., 0][diff]
            zb = z.gather(-1, ref[0][0].long().unsqueeze(-1))[..., 0][diff]
            del z
            rel = (za - zb).abs() / torch.maximum(za.abs(), zb.abs()).clamp_min(1e-6)
            rel_max = rel.max().item() if rel.numel() else 0.0
            within = (rel <= 2.0**-6).float().mean().item() if rel.numel() else 1.0
            _print(f"  {dtype} config {label} vs ref: mask agreement {agree:.6f}; 1/8 logits "
                   f"max |diff| {(logits - ref[1]).abs().max().item():.4g} (ref logits std "
                   f"{ref[1].std().item():.4g}); request 0: {int(diff.sum())} differing "
                   f"pixels, max relative f32 gap {rel_max:.4g}, {within:.4f} of them within "
                   f"2 bf16 ulps")
            if dtype == "float32" and pw == "conv" and agree < MASK_GATE:
                failures.append(f"f32 config {label}: mask agreement {agree} < {MASK_GATE}")
            if pw != "conv":
                sim = engine(impl, mode, dtype, hook=SiteFakeQuant()).predict(reqs[0])
                _print(f"  {dtype} config {label} vs the fake-quant simulation of its int8 "
                       f"grid: mask agreement {(masks[0] == sim).float().mean().item():.6f} "
                       f"(request 0)")
                del sim

    # small f32 input: each config on the card against the CPU (plain
    # versions, no cuDNN); A and B against the kernel-free config, masks
    # equal but for near-ties. C and D against themselves: their int8 sites
    # emit bf16, and from the first one on the network runs on bf16
    # activations, where cuDNN and the CPU round differently and a random
    # network amplifies one ulp into a different mask (PERF.md Findings: the
    # masks agree on ~0.7 of pixels). Their gate is the int8 levels at the
    # first int8 site, the last point the card and the CPU compute in f32:
    # equal on KERNEL_MASK_GATE of the elements, none more than one level
    # apart; the mask agreement is reported.
    small = batches[0][:, :128, :256].contiguous()
    cpu = torch.device("cpu")
    cpu_mask = engine("conv", "matmul", "float32", cpu).predict(small.cpu())
    for label, impl, pw, mode, _ in configs[1:]:
        mask = engine(impl, mode, "float32", pw=pw).predict(small).cpu()
        ref_mask = cpu_mask
        if pw != "conv":
            ref_mask = engine(impl, mode, "float32", cpu, pw=pw).predict(small.cpu())
            first = "ltd/dsconv1/pw" if impl == "pallas" else "gfe/bottleneck1/0/expand"
            levels = []
            for device in (dev, cpu):
                seen = {}

                def grab(y, site=None, seen=seen):
                    if site == first:
                        seen["q"] = quantize_act(y, scale_of[first]).cpu()
                    return y

                engine(impl, mode, "float32", device, hook=grab).predict(small.to(device))
                levels.append(seen["q"])
            flips = int((levels[0] != levels[1]).sum())
            worst = (levels[0].int() - levels[1].int()).abs().max().item()
            _print(f"f32 {tuple(small.shape)} config {label}: int8 levels at {first} on the card "
                   f"vs the CPU: {flips} of {levels[0].numel()} differ (max {worst} level)")
            if flips > (1 - KERNEL_MASK_GATE) * levels[0].numel() or worst > 1:
                failures.append(f"f32 config {label}: {flips} int8 levels differ at {first}")
        agree = (mask == ref_mask).float().mean().item()
        _print(f"f32 {tuple(small.shape)} config {label} on the card vs the CPU: "
               f"mask agreement {agree:.6f}{' (reported)' if pw != 'conv' else ''}")
        if pw == "conv" and agree < KERNEL_MASK_GATE:
            failures.append(f"f32 config {label}: agreement {agree} < {KERNEL_MASK_GATE}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def training_batch(dev):
    """A fixed batch the network can fit: each 32x32 block of a crop takes
    one of the 19 classes at random (seeded), its pixels that class's
    colour plus noise, so the label is a function of the image; 15 % of
    the label pixels are set to -1 (ignored)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, size, block = TRAIN_BATCH, TRAIN_SIZE, 32
    cls = torch.randint(0, NUM_CLASSES, (n, 1, size // block, size // block), generator=g,
                        device=dev)
    cls = F.interpolate(cls.float(), scale_factor=block, mode="nearest").long()[:, 0]
    palette = torch.randint(0, 256, (NUM_CLASSES, 3), generator=g, device=dev).float()
    noise = torch.randint(-24, 25, (n, size, size, 3), generator=g, device=dev).float()
    images = (palette[cls] + noise).clamp(0, 255).to(torch.uint8)
    targets = cls.to(torch.int32)
    targets[torch.rand((n, size, size), generator=g, device=dev) < 0.15] = -1
    return images, targets


def profile_steps(run_step, step_ms, steps=3, top=15):
    """Where a train step's device time goes: ``torch.profiler`` over a few
    steps, the device kernels' self time by name (ms per step and share of
    the step's CUDA-event time ``step_ms``), and the device busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]  # kernels only
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        _print("profile: the profiler recorded no device time (not measured)")
        return
    _print(f"profile of {steps} bf16 train steps: device busy {busy:.2f} ms/step of "
           f"{step_ms:.2f} ms/step ({busy / step_ms:.3f}; idle {1 - busy / step_ms:.3f}), "
           f"{sum(c for _, _, c in rows):.0f} device ops/step; top {top} by self device time:")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        _print(f"  {ms:8.3f} ms/step {ms / busy:6.3f} x{count:5.0f}  {name[:110]}")
    b6 = sum(ms for name, ms, _ in rows if "dw_conv3x3" in name)
    _print(f"  B6 kernels (forward, dX, dW passes): {b6:.3f} ms/step, {b6 / busy:.4f} of device time")


def training_phase():
    """Phase 6: the training path through its entry points. Returns the
    B6 launch counts of the bf16 run and its measurements."""
    import torch

    from fastscnn_tpu_torch.losses import get_loss_fn
    from fastscnn_tpu_torch.models import FastSCNN, init_fast_scnn
    from fastscnn_tpu_torch.ops.cuda import dw_conv3x3_vjp, launch_counts, reset_launch_counts
    from fastscnn_tpu_torch.parallel import create_train_state, make_optimizer, make_train_step
    from fastscnn_tpu_torch.utils import lr_schedule
    from fastscnn_tpu_torch.utils.tree import tree_leaves

    dev = torch.device("cuda")
    images, targets = training_batch(dev)
    _print(f"training batch: images {tuple(images.shape)} {images.dtype}, labels "
           f"{tuple(targets.shape)}, {(targets < 0).float().mean().item():.3f} ignored")
    init = init_fast_scnn(NUM_CLASSES, aux=True, generator=torch.Generator().manual_seed(SEED),
                          device=dev).state_dict()
    loss_fn = get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES)

    def trainer(stem_impl, dtype):
        model = FastSCNN(NUM_CLASSES, aux=True, stem_impl=stem_impl)
        model.load_state_dict(init)
        opt = make_optimizer("sgd", lr_schedule("poly", base_lr=TRAIN_LR, niters=RECIPE_ITERS),
                             momentum=0.9, weight_decay=1e-4)
        state = create_train_state(model, opt, device=dev)
        return state, make_train_step(model, loss_fn, opt, compute_dtype=dtype, device=dev)

    # (a) one f32 step through 'pallas' (B6) and one through 'xla' (cuDNN),
    # from the same weights, no dropout. Batch-stat BN amplifies f32
    # rounding differences between any two formulations (for torch's own
    # f32 against f64 gradients tests/test_training_parity.py measured
    # 3.5e-3), so the yardstick is the same step through 'xla' in f64: the
    # two f32 steps must be as close to each other as F32_STEP_FACTOR times
    # 'xla' f32 is to f64, or within F32_STEP_FLOOR.
    runs = {}
    for label, impl, dtype in (("pallas", "pallas", torch.float32),
                               ("xla", "xla", torch.float32), ("xla-f64", "xla", torch.float64)):
        state, step = trainer(impl, dtype)
        p0 = [t.detach().clone() for t in tree_leaves(state.params)]
        s0 = [t.clone() for t in tree_leaves(state.model_state)]
        state, metrics = step(state, images, targets)
        runs[label] = (
            float(metrics["loss"]),
            torch.cat([(t.detach() - a).flatten() for t, a in zip(tree_leaves(state.params), p0)]),
            torch.cat([(t - a).flatten() for t, a in zip(tree_leaves(state.model_state), s0)]),
        )
        del state, step
        torch.cuda.empty_cache()

    def rel(a, b):
        (la, pa, sa), (lb, pb, sb) = runs[a], runs[b]
        return (abs(la - lb) / abs(lb), ((pa - pb).norm() / pb.norm()).item(),
                ((sa - sb).abs().max() / sb.abs().max()).item())

    got, yard = rel("pallas", "xla"), rel("xla", "xla-f64")
    _print(f"f32 step, stem 'pallas' vs 'xla': loss {runs['pallas'][0]:.7f} vs "
           f"{runs['xla'][0]:.7f}; relative differences (loss, param updates L2, BN-stat "
           f"changes max) {tuple(f'{v:.3g}' for v in got)}; 'xla' f32 vs f64: "
           f"{tuple(f'{v:.3g}' for v in yard)}")
    limits = [max(F32_STEP_FACTOR * y, F32_STEP_FLOOR) for y in yard]
    if any(g > lim for g, lim in zip(got, limits)):
        raise AssertionError(f"f32 'pallas' step disagrees with the 'xla' step: {got} vs "
                             f"limits {limits}")
    del runs
    torch.cuda.empty_cache()

    # (b) the recipe in bf16 on the fixed batch, dropout from a generator
    state, step = trainer("pallas", torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    first = step(state, images, targets, gen)[1]["loss"]  # also cuDNN plans, allocator warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    copies = dw_conv3x3_vjp.g_copies
    losses = [step(state, images, targets, gen)[1]["loss"] for _ in range(TRAIN_STEPS - 1)]
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(losses)
    losses = [float(v) for v in [first, *losses]]
    _print(f"bf16 steps 1..{TRAIN_STEPS}: losses {[round(v, 4) for v in losses]}")
    _print(f"  launches over steps 2..{TRAIN_STEPS}: {counts}; gradient copies before B6's backward: "
           f"{dw_conv3x3_vjp.g_copies - copies}")
    want = {"dw_conv3x3": 2 * steps, "dw_conv3x3_dx": 2 * steps, "dw_conv3x3_dw": 2 * steps}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"B6 launches {counts}, expected {want}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise AssertionError("non-finite training loss")
    falls = sum(b < a for a, b in zip(losses, losses[1:]))
    _print(f"  last / first loss {losses[-1] / losses[0]:.4f}; the loss fell on {falls} of "
           f"{len(losses) - 1} steps")
    if not (losses[-1] < 0.95 * losses[0] and falls >= 0.75 * (len(losses) - 1)):
        raise AssertionError(f"training loss did not fall: {losses}")

    # (d) speed: CUDA events around windows of steps, after warm-up
    times = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        start.record()
        for _ in range(5):
            step(state, images, targets, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 5)
    ms = statistics.median(times)
    _print(f"bf16 train step, {TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}: {ms:.2f} ms/step (median "
           f"of 3 windows of 5 steps, {[round(t, 2) for t in times]}), "
           f"{TRAIN_BATCH * 1e3 / ms:.1f} samples/s, peak memory {peak / 2**30:.2f} GiB")
    profile_steps(lambda: step(state, images, targets, gen), ms)
    return {"dw_conv3x3_vjp:forward": counts["dw_conv3x3"],
            "dw_conv3x3_vjp:dx": counts["dw_conv3x3_dx"],
            "dw_conv3x3_vjp:dw": counts["dw_conv3x3_dw"]}


# the depthwise kernels' rows of the kernel table, and the library call each
# is held against
DW_LIBRARY = {"dw_conv3x3": "cuDNN depthwise + ReLU", "dw_conv3x3_vjp:forward": "cuDNN depthwise",
              "dw_conv3x3_vjp:dw": "conv2d_weight"}
SERVING_DW_SITES = (("dsconv1", 1, 511, 1023, 32), ("dsconv2", 1, 256, 512, 48))


def dw_costs():
    """The depthwise forward and dW at the main path's sites, each beside
    the cuDNN call that computes the same function (the yardsticks of
    phases 3 and 5), every call costed by :func:`call_costs`: B4
    (``dw_conv3x3`` with bias and ReLU, N = 1) at the serving sites, B6's
    forward and dW (bf16 out) at the training sites, bf16. It passes the
    wrappers only arguments that every version of the port takes, so that
    ``--dw-ab`` costs an older checkout's kernels the same way. Returns
    ``{row: {"kernel": costs, "library": costs, "sites": {site: {...}}}}``,
    the row's costs summed over its sites."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from fastscnn_tpu_torch.ops import cuda as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    rows = {}

    def add(row, site, kern, lib):
        costs = {"kernel": call_costs(kern), "library": call_costs(lib)}
        r = rows.setdefault(row, {part: dict.fromkeys(c, 0.0) for part, c in costs.items()})
        r.setdefault("sites", {})[site] = costs
        for part, c in costs.items():
            for key, v in c.items():
                r[part][key] += v

    for site, n, h, w, c in SERVING_DW_SITES:
        x = randn(n, h, w, c).clamp_min(0)
        wt, b = randn(3, 3, 1, c, scale=0.3), randn(c, scale=0.1)
        xc, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        add("dw_conv3x3", site, lambda: K.dw_conv3x3(x, wt, b, 2, 1, True),
            lambda: F.relu(F.conv2d(xc, w_oihw, b, stride=2, padding=1, groups=c)))
    for site, n, h, w, c in B6_SITES:
        ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        x = randn(n, h, w, c).clamp_min(0)
        wt, gy = randn(3, 3, 1, c, scale=0.3), randn(n, ho, wo, c, scale=0.01)
        xc, gc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        add("dw_conv3x3_vjp:forward", site, lambda: K.dw_conv3x3(x, wt, None, 2, 1),
            lambda: F.conv2d(xc, w_oihw, stride=2, padding=1, groups=c))
        add("dw_conv3x3_vjp:dw", site, lambda: K.dw_conv3x3_dw(x, gy, 2, 1, bf16),
            lambda: conv2d_weight(xc, (c, 1, 3, 3), gc, stride=2, padding=1, groups=c))
        del x, gy, xc, gc
    torch.cuda.empty_cache()
    return rows


def print_dw_costs(rows, tag=""):
    """One line a site and one for the sum, kernel against library: device
    ms, ms of a window without the spin, host us a call."""
    def fmt(k, lib):
        return (f"device {k['device_ms']:.4f} vs {lib['device_ms']:.4f} ms, without the spin "
                f"{k['window_ms']:.4f} vs {lib['window_ms']:.4f} ms, host {k['host_us']:.1f} vs "
                f"{lib['host_us']:.1f} us")

    for row, r in rows.items():
        for site, c in r["sites"].items():
            _print(f"  {tag}{row}[{site}]: kernel vs {DW_LIBRARY[row]}: "
                   f"{fmt(c['kernel'], c['library'])}")
        k, lib = r["kernel"], r["library"]
        verdict = ", ".join(f"{'faster' if k[m] <= lib[m] else 'SLOWER'} {what}"
                            for m, what in (("device_ms", "on the device"),
                                            ("window_ms", "without the spin")))
        _print(f"  {tag}{row} over its sites: {fmt(k, lib)}; {verdict}")


def dw_ab(parent: str) -> None:
    """``--dw-ab PARENT``: :func:`dw_costs` for the checkout of this repo
    at PARENT (an older commit, unpacked with ``git archive``) and for this
    one, each in a process of its own that builds its kernels from its own
    sources, in the order PARENT, this, this, PARENT on one card."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "this tree": []}
    for which, root in (("parent", parent), ("this tree", here), ("this tree", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--dw-costs", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"--dw-costs {root} failed:\n{proc.stdout[-4000:]}"
                               f"{proc.stderr[-4000:]}")
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(rows)
        _print(f"{which} ({root}):")
        print_dw_costs(rows)
    _print("summary, kernel over its sites (parent's two runs | this tree's two runs), library alike:")
    for row in DW_LIBRARY:
        for part in ("kernel", "library"):
            for key in ("device_ms", "window_ms", "host_us"):
                vals = [f"{r[row][part][key]:.4f}" for which in runs for r in runs[which]]
                _print(f"  {row} {part} {key}: {vals[0]} {vals[1]} | {vals[2]} {vals[3]}")


def tune_dw() -> None:
    """``--tune-dw``: the evidence for the depthwise launch plans. The
    registers, spills and shared memory ``nvcc -Xptxas -v`` reports for the
    forward (bf16, VEC 8, stride 2, at each output-column count it is built
    for) and dW's pass 1 (bf16, VEC 8, stride 2); then the device ms
    (:func:`time_ms`) at the main path's four sites: the forward at 2, 3
    and 4 output columns by 1 to 16 output rows a thread, each result held
    bit for bit against its plain version, and dW at 528 to 1,584 pass-1
    blocks aimed at. ``*`` marks the plan the wrappers pick."""
    import re

    import torch

    from fastscnn_tpu_torch.ops import cuda as K
    from fastscnn_tpu_torch.ops.cuda import _build
    from fastscnn_tpu_torch.ops.cuda.dw_conv import FWD_COLS, _DW_BLOCKS, dw_fwd_plan, dw_plan

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, kernel in (("dw_conv", "dw_conv3x3_kernel"), ("dw_conv_bwd", "dw_partial_kernel")):
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-o",
             str(_build.BUILD_DIR / f"{name}-ptxas.so"), str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True, timeout=600).stderr
        entry = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif (entry and kernel in entry and "bfloat16Li8ELi2E" in entry
                  and ("Used" in line or "spill" in line)):
                cols = re.search(r"bfloat16Li8ELi2ELi(\d)E", entry)
                what = f", {cols.group(1)} columns" if cols else ""
                _print(f"  {kernel}<bf16, VEC 8, stride 2{what}>: "
                       f"{re.sub(r'.*info *: ', '', line).strip()}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    bf16 = torch.bfloat16
    sites = [("serving " + s, n, h, w, c, True) for s, n, h, w, c in SERVING_DW_SITES]
    sites += [("training " + s, n, h, w, c, False) for s, n, h, w, c in B6_SITES]
    for site, n, h, w, c, bias in sites:
        x = torch.randn((n, h, w, c), generator=g, device=dev).clamp_min(0).to(bf16)
        wt = (torch.randn((3, 3, 1, c), generator=g, device=dev) * 0.3).to(bf16)
        b = (torch.randn((c,), generator=g, device=dev) * 0.1).to(bf16) if bias else None
        ref = K.dw_conv3x3_reference(x, wt, b, 2, 1, bias)
        ho, wo = ref.shape[1], ref.shape[2]
        chosen = dw_fwd_plan(n, ho, wo, c, 8, 2)
        for cols in FWD_COLS:
            cells = []
            for rows in (1, 2, 4, 8, 16):
                if not torch.equal(K.dw_conv3x3(x, wt, b, 2, 1, bias, rows=rows, cols=cols), ref):
                    raise AssertionError(f"{site}: forward at {cols}x{rows} differs from its plain "
                                         "version")
                ms = time_ms(lambda: K.dw_conv3x3(x, wt, b, 2, 1, bias, rows=rows, cols=cols))
                mark = "*" if (cols, rows) == (chosen.cols, chosen.rows) else ""
                cells.append(f"{rows}{mark}: {ms:.4f}")
            _print(f"  {site} forward, {cols} columns, ms by output rows a thread: "
                   f"{', '.join(cells)}")
        if bias:
            continue
        gy = (torch.randn((n, ho, wo, c), generator=g, device=dev) * 0.01).to(bf16)
        cells = []
        for target in (528, 792, 1056, 1584):
            blocks = dw_plan(n * ho, c, 8, target)[1]
            ms = time_ms(lambda: K.dw_conv3x3_dw(x, gy, 2, 1, bf16, blocks=target))
            cells.append(f"{target}{'*' if target == _DW_BLOCKS else ''} ({blocks} blocks): "
                         f"{ms:.4f}")
        _print(f"  {site} dW, ms by pass-1 blocks aimed at: {', '.join(cells)}")
        del x, gy, ref
        torch.cuda.empty_cache()


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tune-dw", action="store_true",
                        help="only the depthwise kernels' registers and launch-plan sweeps")
    parser.add_argument("--dw-ab", metavar="PARENT",
                        help="only the depthwise kernels' costs, for the checkout at PARENT and "
                             "for this one")
    parser.add_argument("--dw-costs", metavar="ROOT", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.dw_costs or os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import fastscnn_tpu_torch
    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.ops.cuda import _build

    if not os.path.abspath(fastscnn_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"fastscnn_tpu_torch imported from {fastscnn_tpu_torch.__file__}, "
                           f"not from {root}")
    if args.dw_costs:
        _build.build_all()
        print(json.dumps(dw_costs()))
        return 0
    resolve_device(None)  # TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    _print(smi)
    _print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
           f"count {torch.cuda.device_count()}")
    if args.dw_ab:
        dw_ab(os.path.abspath(args.dw_ab))
        return 0
    if args.tune_dw:
        _build.build_all()
        tune_dw()
        return 0
    peak_name, peaks = card_peaks(name)
    _print(f"bounds use the published {peak_name} peaks: {peaks['bytes'] / 1e12} TB/s; "
           f"{peaks['f32'] / 1e12} TFLOP/s f32, {peaks['bf16'] / 1e12} TFLOP/s bf16 and "
           f"{peaks['int8'] / 1e12} TOP/s int8 on the tensor cores")

    t0 = time.perf_counter()
    _build.build_all()
    _print(f"build: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _print("depthwise forward and dW on a sweep of small shapes:")
    dw_sweep()
    _print(f"  sweep: {time.perf_counter() - t0:.1f} s")

    _print("kernels at the serving path's shapes (N=1, bf16), B6 at the training stem's "
           "(N=16, bf16), then B7 and B8 at a frame's int8 sites (N=1):")
    kernels = kernel_phase(peaks)
    _print("the depthwise kernels beside their library calls, timed three ways (device; "
           "windows without the spin, host issue time included; host us a call):")
    print_dw_costs(dw_costs())
    launches = serving_phase()
    launches.update(training_phase())
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its path")
    _print(json.dumps({"kernels": kernels}))
    _print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
