"""Observability / analysis tools.

The port's own copy of ``fastscnn_tpu/tools/analyzers.py``, ports of the
reference's monitoring scripts:

- ``analyze_training_log``   — training-log analysis + tuning hints over
  the JSON log of :class:`~fastscnn_tpu_torch.utils.monitor.TrainingMonitor`
  (reference:analyze_training_results.py)
- ``ControlLatencyAnalyzer`` — send-latency/interval statistics under a
  lock (reference:serial_control_performance_analyzer.py:14-30)
- ``monitor_fps``            — HTTP polling of a running dashboard's
  /api/stats (``interfaces/web_interface.py``) against an FPS SLO
  (reference:monitor_8fps_performance.py:12-30)
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
import urllib.request

__all__ = ["analyze_training_log", "ControlLatencyAnalyzer", "monitor_fps", "main"]


def analyze_training_log(log_path: str) -> dict:
    """Summarize a TrainingMonitor JSON log: best epoch, convergence trend,
    throughput, and tuning hints."""
    with open(log_path) as f:
        records = json.load(f)
    if not records:
        return {"epochs": 0}
    losses = [r["train_loss"] for r in records]
    summary: dict = {
        "epochs": len(records),
        "final_loss": losses[-1],
        "best_loss": min(losses),
        "loss_improved_pct": 100.0 * (losses[0] - losses[-1]) / max(abs(losses[0]), 1e-9),
    }
    val = [r for r in records if "miou" in r]
    if val:
        best = max(val, key=lambda r: r.get("combined_metric", 0))
        summary.update(
            best_epoch=best["epoch"],
            best_miou=best["miou"],
            best_pix_acc=best["pix_acc"],
            final_miou=val[-1]["miou"],
        )
        if val[-1]["miou"] < best["miou"] - 0.01:
            summary["hint"] = "val mIoU regressed from its best — consider early stopping"
    sps = [r["samples_per_sec"] for r in records if "samples_per_sec" in r]
    if sps:
        summary["mean_samples_per_sec"] = statistics.mean(sps)
    if len(losses) >= 6 and statistics.mean(losses[-3:]) > statistics.mean(losses[-6:-3]) * 0.995:
        summary.setdefault("hint", "loss plateaued — lower LR or stop")
    return summary


class ControlLatencyAnalyzer:
    """Thread-safe collection of control-send latencies and intervals."""

    def __init__(self):
        self._lock = threading.Lock()
        self.latencies: list[float] = []
        self.intervals: list[float] = []
        self._last_send: float | None = None

    def record_send(self, latency_sec: float, now: float | None = None):
        now = time.time() if now is None else now
        with self._lock:
            self.latencies.append(latency_sec)
            if self._last_send is not None:
                self.intervals.append(now - self._last_send)
            self._last_send = now

    def stats(self) -> dict:
        with self._lock:
            lat, itv = list(self.latencies), list(self.intervals)
        out: dict = {"sends": len(lat)}
        if lat:
            out.update(
                latency_mean_ms=1e3 * statistics.mean(lat),
                latency_max_ms=1e3 * max(lat),
                latency_p95_ms=1e3 * sorted(lat)[int(0.95 * (len(lat) - 1))],
            )
        if itv:
            out.update(
                interval_mean_ms=1e3 * statistics.mean(itv),
                effective_hz=1.0 / statistics.mean(itv) if statistics.mean(itv) > 0 else 0.0,
            )
        return out

    def report(self) -> str:
        s = self.stats()
        lines = ["=== control latency analysis ==="]
        for k, v in s.items():
            lines.append(f"  {k}: {v:.2f}" if isinstance(v, float) else f"  {k}: {v}")
        # hard real-time check: command interval must stay under the 500 ms
        # firmware watchdog (reference:car/simple_car_controller_stm32.c:74-81)
        if "interval_mean_ms" in s and s["interval_mean_ms"] > 400:
            lines.append("  WARNING: mean interval near the 500 ms firmware watchdog!")
        return "\n".join(lines)


def monitor_fps(
    base_url: str,
    target_fps: float = 8.0,
    duration_sec: float = 10.0,
    poll_interval: float = 0.5,
) -> dict:
    """Poll /api/stats and evaluate the FPS SLO."""
    samples = []
    deadline = time.time() + duration_sec
    while time.time() < deadline:
        try:
            stats = json.loads(
                urllib.request.urlopen(f"{base_url}/api/stats", timeout=2).read()
            )
            if stats.get("fps"):
                samples.append(stats["fps"])
        except Exception:
            pass
        time.sleep(poll_interval)
    if not samples:
        return {"samples": 0, "slo_met": False}
    mean_fps = statistics.mean(samples)
    return {
        "samples": len(samples),
        "mean_fps": mean_fps,
        "min_fps": min(samples),
        "target_fps": target_fps,
        "slo_met": mean_fps >= target_fps,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="analysis tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("training")
    p.add_argument("--log", required=True)
    p = sub.add_parser("fps")
    p.add_argument("--url", default="http://127.0.0.1:5000")
    p.add_argument("--target", type=float, default=8.0)
    p.add_argument("--duration", type=float, default=10.0)
    args = parser.parse_args(argv)
    if args.cmd == "training":
        print(json.dumps(analyze_training_log(args.log), indent=2))
    elif args.cmd == "fps":
        print(json.dumps(monitor_fps(args.url, args.target, args.duration), indent=2))


if __name__ == "__main__":
    main()
