"""Per-kernel attribution of a ``torch.profiler`` device trace.

Counterpart of ``fastscnn_tpu/tools/xplane.py``: the table of device
time by kernel — self time, occurrences and, where the trace carries
them, bytes and operations for a roofline check — over the Chrome-trace
JSON that ``fastscnn_tpu_torch.utils.profiling.device_trace`` writes.

Usage::

    python -m fastscnn_tpu_torch.tools.xplane TRACE_DIR [--top N] [--iters K] [--roofline]

``TRACE_DIR`` is the directory passed to ``device_trace``; the newest
``*.pt.trace.json`` underneath is read. ``--iters`` divides times by the
number of iterations inside the traced block so rows read as
per-iteration. Only the card's kernels count (events of category
``kernel``); host operators, copies and memsets are skipped, as the JAX
tool counts only the device's "XLA Ops" line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

from fastscnn_tpu_torch.utils.profiling import TRACE_SUFFIX

__all__ = ["device_op_table", "main", "HBM_GBPS", "TC_TFLOPS_BF16"]


def _load_trace(trace_dir: str):
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {trace_dir}")
    with open(paths[-1]) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return events, paths[-1]


def device_op_table(trace_dir: str):
    """Aggregate the device kernel events of the newest trace under
    ``trace_dir`` → ``(rows, total_device_seconds, path)``, rows
    ``{name, time_ps, count, bytes, flops}`` sorted by self time. A Chrome
    trace holds no cost figures for a kernel, so ``bytes`` and ``flops``
    are 0 unless an event's ``args`` carries them."""
    events, path = _load_trace(trace_dir)
    rows: dict[str, dict] = defaultdict(
        lambda: {"time_ps": 0, "count": 0, "bytes": 0, "flops": 0}
    )
    total_ps = 0
    for event in events:
        if event.get("cat") != "kernel" or event.get("ph") != "X":
            continue
        r = rows[event["name"]]
        ps = int(round(float(event.get("dur", 0)) * 1e6))  # microseconds → picoseconds
        r["time_ps"] += ps
        r["count"] += 1
        args = event.get("args") or {}
        r["bytes"] += int(args.get("bytes_accessed", 0))
        r["flops"] += int(args.get("flops", 0))
        total_ps += ps
    out = [dict(name=k, **v) for k, v in rows.items()]
    out.sort(key=lambda r: -r["time_ps"])
    return out, total_ps / 1e12, path


# NVIDIA H100 SXM peaks from its data sheet (dense): HBM3 bytes/s and the
# tensor cores' bf16 rate, the figures the kernels' bounds use
HBM_GBPS = 3350.0
TC_TFLOPS_BF16 = 989.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--iters", type=int, default=1,
                    help="iterations inside the traced block")
    ap.add_argument("--roofline", action="store_true",
                    help="add per-kernel FLOPs, HBM/tensor-core floor times, the "
                    "binding roofline, and %%-of-floor columns (NVIDIA H100 SXM "
                    "peaks: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3). A kernel "
                    "without cost figures in the trace says so in those columns. "
                    "NB a kernel that works from shared memory can sit far above "
                    "both floors: the floors bound, they don't explain.")
    args = ap.parse_args(argv)
    rows, total_s, path = device_op_table(args.trace_dir)
    k = args.iters
    print(f"# {path}")
    print(f"# device total: {1e3 * total_s / k:.2f} ms/iter over {len(rows)} kernels")
    if not args.roofline:
        print(f"{'ms/iter':>9} {'%':>5} {'count':>6} {'GB/s':>7}  name")
        for r in rows[: args.top]:
            ms = 1e3 * r["time_ps"] / 1e12 / k
            pct = 100.0 * r["time_ps"] / (total_s * 1e12) if total_s else 0.0
            gbs = (f"{r['bytes'] / (r['time_ps'] / 1e12) / 1e9:7.0f}"
                   if r["time_ps"] and r["bytes"] else f"{'-':>7}")
            print(f"{ms:9.3f} {pct:5.1f} {r['count']:6d} {gbs}  {r['name'][:110]}")
        return
    print(f"{'ms/iter':>9} {'%':>5} {'GB/s':>7} {'GFLOP':>8} "
          f"{'hbm_ms':>8} {'tc_ms':>8} {'bound':>5} {'xfloor':>7}  name")
    floor_total_ms = 0.0
    for r in rows:
        hbm_ms = 1e3 * (r["bytes"] / k) / (HBM_GBPS * 1e9)
        tc_ms = 1e3 * (r["flops"] / k) / (TC_TFLOPS_BF16 * 1e12)
        floor_total_ms += max(hbm_ms, tc_ms)
    for r in rows[: args.top]:
        ms = 1e3 * r["time_ps"] / 1e12 / k
        pct = 100.0 * r["time_ps"] / (total_s * 1e12) if total_s else 0.0
        if not (r["bytes"] or r["flops"]):
            print(f"{ms:9.3f} {pct:5.1f} {'-':>7} {'-':>8} {'-':>8} {'-':>8} {'-':>5} "
                  f"{'-':>7}   {r['name'][:90]} (no cost figures in the trace)")
            continue
        gbs = (r["bytes"] / (r["time_ps"] / 1e12) / 1e9) if r["time_ps"] else 0.0
        gflop = r["flops"] / k / 1e9
        hbm_ms = 1e3 * (r["bytes"] / k) / (HBM_GBPS * 1e9)
        tc_ms = 1e3 * (r["flops"] / k) / (TC_TFLOPS_BF16 * 1e12)
        bound = "tc" if tc_ms > hbm_ms else "hbm"
        floor = max(hbm_ms, tc_ms)
        xfloor = ms / floor if floor > 0 else float("inf")
        print(f"{ms:9.3f} {pct:5.1f} {gbs:7.0f} {gflop:8.2f} "
              f"{hbm_ms:8.3f} {tc_ms:8.3f} {bound:>5} "
              f"{xfloor:7.1f}x  {r['name'][:90]}")
    total_ms = 1e3 * total_s / k
    if total_ms > 0 and floor_total_ms > 0:
        print(f"# composable bound: sum of per-kernel max(hbm,tc) floors = "
              f"{floor_total_ms:.2f} ms/iter → floor is "
              f"{100.0 * floor_total_ms / total_ms:.0f}% of measured "
              f"({total_ms:.2f} ms); kernels above both floors are latency-, "
              f"issue- or schedule-bound, not mismeasured")
    else:
        print("# no device kernels with cost figures in this trace "
              "(a torch.profiler Chrome trace carries no bytes or operations for a kernel)")


if __name__ == "__main__":
    main()
