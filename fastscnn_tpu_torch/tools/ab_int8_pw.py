"""Per-op A/B of the int8 pointwise-conv kernels (B7, B8) against the bf16
1×1 conv, at the (M, K, N) of every 1×1 site of the 1024×2048 serving graph.

    python -m fastscnn_tpu_torch.tools.ab_int8_pw [--batch 16] [--iters 30]
        [--repeat 3] [--block-m B] [--sites a,b] [--out FILE] [--device cpu]

The port of the repo root's ``tools/ab_int8_pw.py``, with the same sites,
flags, variants and JSON, plus ``--device`` (default: the CUDA card; raises
without one). The serving graph's 1×1 convs move few operations a byte, so
the int8 kernels can win only by moving fewer bytes; this tool measures
whether they do on the card. The variants, each on the site's seeded
inputs (``np.random.default_rng(0)``, drawn in the JAX tool's order, so the
inputs equal its own bit for bit):

- ``bf16-xla``: the baseline, one ``torch.addmm`` in bf16 (the bias
  rounded to bf16, as the serving graph folds it) and a ReLU — a library
  product outside any kernel of the port, as the JAX baseline is a
  ``jnp.dot`` outside any Pallas kernel;
- ``a8-bf16out`` and ``a8-i8out``: B7 (``ops/cuda/int8_pw.py::pw_conv_a8``)
  to bf16 and to int8;
- ``w8a8-i8out``: B8 (``pw_conv_w8a8``) to int8.

Timing: the JAX tool's on-device loop. ``iters`` calls run in one CUDA
graph, each call's ``out[0, 0] % 2`` added to ``x[0, 0]`` so that no call
can be hoisted; a run is the host clock around a replay and the read-back
of ``x[0, 0]``, and the result is the best of ``repeat`` runs. On the CPU
(when asked for) the same loop runs eagerly. The loop's own cost a call
(the dependence's two or three one-element kernels, the replay and the
read-back, shared out over ``iters``) is timed by the same loop around a
call that returns a fixed output, and reported beside each row as
``loop_us``, with ``net_GB/s`` over ``us - loop_us``. ``quantize_act`` is
not counted: in deployment it fuses into the producing op, as the bf16
baseline gets its input free from the previous op. GB/s counts each input
byte once and each output byte once, the JAX tool's formula.

``--block-m B`` forces the kernels' block tile whose BM is B
(``PW_A8_TILES`` for B7, ``PW_W8A8_TILES`` for B8; where B8 has two such
tiles, the one its launch plan takes at the site); a B that no tile has
raises. The TPU's ``block_m`` row blocks have no counterpart. Each row
reports the tile that ran (``BMxBN``; ``library`` for the baseline).

Prints one JSON line ``{"batch", "iters", "sites": {name: {"m", "k", "n",
"rows": {variant: {"us", "GB/s", "tile", "loop_us", "net_GB/s"}}}}}`` (and
writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# (name, h, w, k, n): spatial at 1024×2048 input; M = batch·h·w
SITES = [
    ("ds1-pw", 256, 512, 32, 48),
    ("ds2-pw", 128, 256, 48, 64),
    ("b1.1-expand", 128, 256, 64, 384),
    ("b1.1-project", 64, 128, 384, 64),
    ("b1.2-expand", 64, 128, 64, 384),
    ("b2.2-expand", 32, 64, 96, 576),
    ("ffm-high", 128, 256, 64, 128),
    ("ffm-low-pw", 128, 256, 128, 128),
    ("cls-ds-pw", 128, 256, 128, 128),
]


def _time_loop(build_fn, x0, iters, repeat):
    """Best seconds a call of ``build_fn`` over ``repeat`` runs of a loop
    of ``iters`` calls, each on the input the previous output changed."""
    import torch

    device = x0.device

    def body():
        x = x0.clone()
        for _ in range(iters):
            out = build_fn(x)
            # iteration dependence: one element of the output perturbs one
            # element of the input (int8-safe arithmetic)
            x[0, 0].add_((out[0, 0] % 2).to(x.dtype))
        return x

    if device.type == "cuda":
        from fastscnn_tpu_torch.utils.cuda_graph import capture

        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            body()  # warm-up: the library's plans, the kernels' first launches
        torch.cuda.current_stream(device).wait_stream(stream)
        run = capture(body, device, torch.cuda.graph_pool_handle(), stream).replay
    else:
        run = body
    float(run()[0, 0])  # warm
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        float(run()[0, 0])  # the read-back waits for the loop
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def forced_tile(tiles, block_m, plan_tile: int) -> int:
    """The index in ``tiles`` ((BM, BN, threads) each) of the tile whose BM
    is ``block_m``: the plan's own tile where it is one of them, else the
    first. Raises ``ValueError`` naming the tiles when none has it."""
    have = [i for i, (bm, _, _) in enumerate(tiles) if bm == block_m]
    if not have:
        raise ValueError(f"--block-m {block_m}: no block tile has BM {block_m}; the tiles "
                         f"(BM x BN) are {', '.join(f'{bm}x{bn}' for bm, bn, _ in tiles)}")
    return plan_tile if plan_tile in have else have[0]


def site_tiles(m, k, n, block_m=None) -> tuple[int, int]:
    """B7's and B8's tile indices at an (M, K, N) site: their launch plans',
    or the tiles ``block_m`` forces."""
    from fastscnn_tpu_torch.ops.cuda.int8_pw import (
        PW_A8_TILES,
        PW_W8A8_TILES,
        pw_a8_plan,
        pw_w8a8_plan,
    )

    a8, w8a8 = pw_a8_plan(m, k, n).tile, pw_w8a8_plan(m, k, n).tile
    if block_m is None:
        return a8, w8a8
    return forced_tile(PW_A8_TILES, block_m, a8), forced_tile(PW_W8A8_TILES, block_m, w8a8)


def site_inputs(m, k, n, rng, device) -> dict:
    """The site's operands, drawn from ``rng`` in the JAX tool's order (w,
    b, x_bf, x_q; then w_q and cs from w), on ``device``: ``w`` f32 and
    ``w_bf`` bf16 (K, N), ``b`` f32 (N,), ``x_bf`` bf16 and ``x_q`` int8
    (M, K), ``w_q`` int8 (K, N), ``cs`` f32 (N,)."""
    import torch

    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    x_bf = torch.from_numpy(rng.normal(0, 1, (m, k))).to(torch.bfloat16)
    x_q = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w_q = np.clip(np.round(w / (np.abs(w).max(0) / 127.0)), -127, 127).astype(np.int8)
    cs = (np.abs(w).max(0) / 127.0 * 0.01).astype(np.float32)
    out = {"w": torch.from_numpy(w), "b": torch.from_numpy(b), "x_bf": x_bf, "x_q": x_q,
           "w_bf": torch.from_numpy(w).to(torch.bfloat16), "w_q": torch.from_numpy(w_q),
           "cs": torch.from_numpy(cs)}
    return {key: v.to(device) for key, v in out.items()}


def variants(inp, tiles) -> dict:
    """``{variant: (fn, x0, input bytes an element, output bytes an
    element, tile label)}`` of the JAX tool's four variants on the site's
    operands ``inp`` (:func:`site_inputs`), B7 and B8 at tile indices
    ``tiles`` (:func:`site_tiles`)."""
    import torch

    from fastscnn_tpu_torch.ops.cuda.int8_pw import (
        PW_A8_TILES,
        PW_W8A8_TILES,
        pw_conv_a8,
        pw_conv_w8a8,
    )

    a8, w8a8 = tiles
    w_bf, b, w_q, cs = inp["w_bf"], inp["b"], inp["w_q"], inp["cs"]
    b_bf = b.to(torch.bfloat16)

    def label(table, i):
        return f"{table[i][0]}x{table[i][1]}"

    return {
        "bf16-xla": (lambda x: torch.addmm(b_bf, x, w_bf).relu_(), inp["x_bf"], 2, 2,
                     "library"),
        "a8-bf16out": (lambda x: pw_conv_a8(x, w_bf, b, tile=a8), inp["x_q"], 1, 2,
                       label(PW_A8_TILES, a8)),
        "a8-i8out": (lambda x: pw_conv_a8(x, w_bf, b, quantize_out=True, tile=a8),
                     inp["x_q"], 1, 1, label(PW_A8_TILES, a8)),
        "w8a8-i8out": (lambda x: pw_conv_w8a8(x, w_q, cs, b, quantize_out=True, tile=w8a8),
                       inp["x_q"], 1, 1, label(PW_W8A8_TILES, w8a8)),
    }


def run_site(name, m, k, n, iters, repeat, rng, block_m=None, device=None, check=None):
    """Each variant's best µs and GB/s at one site, with the loop's own µs
    and the GB/s net of it, printed and returned as ``{variant: {"us",
    "GB/s", "tile", "loop_us", "net_GB/s"}}``. ``check(name, inputs, variants)``,
    if given, sees the site's operands and variants before they are timed."""
    tiles = site_tiles(m, k, n, block_m)
    inp = site_inputs(m, k, n, rng, device)
    vs = variants(inp, tiles)
    if check is not None:
        check(name, inp, vs)
    rows = {}
    base = None
    for vname, (fn, x0, in_b, out_b, tile) in vs.items():
        sec = _time_loop(fn, x0, iters, repeat)
        fixed = fn(x0)
        loop = _time_loop(lambda x: fixed, x0, iters, repeat)  # the loop alone
        nbytes = m * k * in_b + m * n * out_b
        gbs = nbytes / sec / 1e9
        net = nbytes / (sec - loop) / 1e9 if sec > loop else None
        rows[vname] = {"us": sec * 1e6, "GB/s": gbs, "tile": tile, "loop_us": loop * 1e6,
                       "net_GB/s": net}
        if vname == "bf16-xla":
            base = sec
        print(
            f"  {name:14s} {vname:11s} {sec*1e6:9.1f} us  {gbs:7.1f} GB/s"
            f"  {'' if base is None else f'x{base/sec:.2f}'}  tile {tile}"
            f"  (loop {loop*1e6:.1f} us, net {'-' if net is None else f'{net:.1f}'} GB/s)",
            flush=True,
        )
    return rows


def main(argv=None, check=None) -> dict:
    """The A/B; ``check`` as in :func:`run_site`. Returns the JSON object."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--block-m", type=int, default=None,
                   help="force the block tile with this many rows (BM)")
    p.add_argument("--sites", default=None, help="comma-separated site-name filter")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (raises without one)")
    args = p.parse_args(argv)

    import torch

    from fastscnn_tpu_torch import resolve_device

    device = resolve_device(args.device)
    if args.block_m is not None:  # refuse a BM no tile has before any work
        site_tiles(32, 32, 32, args.block_m)
    rng = np.random.default_rng(0)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}, batch {args.batch}", flush=True)
    results = {}
    keep = set(args.sites.split(",")) if args.sites else None
    for site, h, w, k, n in SITES:
        if keep and site not in keep:
            continue
        m = args.batch * h * w
        results[site] = {
            "m": m, "k": k, "n": n,
            "rows": run_site(site, m, k, n, args.iters, args.repeat, rng, args.block_m,
                             device, check),
        }
    out = {"batch": args.batch, "iters": args.iters, "sites": results}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
