#!/usr/bin/env python
"""Summarize ``fastscnn_tpu_torch/tools/ab_stem.sh`` output into per-impl
medians.

    python -m fastscnn_tpu_torch.tools.ab_report [build/ab_stem_results.log]

The port of the repo root's ``tools/ab_report.py``: the same parser and
summary. The A/B log interleaves ``--- rep R <knob>=<impl>`` markers with
one JSON line per bench invocation (``{"metric", "value", "unit", ...}``);
numbers drift from run to run, so the summary reports per-impl median and
spread plus the interleaved deltas against the baseline impl within each
rep, the comparison an interleaved A/B/A/B run can trust. The port's
``bench`` reports ``fps/card`` where the root bench reported ``fps/chip``;
both units take ``conv`` as their baseline, so a log of either reads the
same. Host only: it touches no device.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from collections import defaultdict

BASELINES = {"fps/card": "conv", "fps/chip": "conv", "samples/sec/chip": "xla",
             "samples/s": "xla"}
DEFAULT_LOG = "build/ab_stem_results.log"


def parse(path: str):
    runs = []  # (unit, rep, impl, value)
    rep, impl = None, None
    with open(path) as f:
        for line in f:
            m = re.match(r"--- rep (\d+) (?:dw_impl|stem_impl)=(\S+)", line.strip())
            if m:
                rep, impl = int(m.group(1)), m.group(2)
                continue
            line = line.strip()
            if line.startswith("{") and '"metric"' in line:
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if impl is not None:
                    runs.append((d.get("unit", "?"), rep, impl, float(d["value"])))
    return runs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DEFAULT_LOG
    runs = parse(path)
    if not runs:
        print(f"no bench JSON lines found in {path}")
        return
    by_unit: dict = defaultdict(lambda: defaultdict(list))
    by_rep: dict = defaultdict(dict)
    for unit, rep, impl, val in runs:
        by_unit[unit][impl].append(val)
        by_rep[(unit, rep)][impl] = val
    for unit, impls in by_unit.items():
        base = BASELINES.get(unit)
        print(f"\n== {unit} ==")
        base_med = statistics.median(impls[base]) if base in impls else None
        for impl, vals in sorted(impls.items(), key=lambda kv: -statistics.median(kv[1])):
            med = statistics.median(vals)
            spread = (max(vals) - min(vals)) / med * 100 if med else 0.0
            rel = f"  {med / base_med - 1:+7.1%} vs {base}" if base_med and impl != base else ""
            print(f"  {impl:12s} median {med:9.1f}  (n={len(vals)}, spread {spread:4.1f}%){rel}")
        # interleaved per-rep deltas (the trustworthy comparison)
        if base_med:
            for (u, rep), vals in sorted(by_rep.items()):
                if u != unit or base not in vals:
                    continue
                deltas = ", ".join(
                    f"{impl} {vals[impl] / vals[base] - 1:+.1%}"
                    for impl in sorted(vals)
                    if impl != base
                )
                print(f"  rep {rep} vs {base}: {deltas}")


if __name__ == "__main__":
    main()
