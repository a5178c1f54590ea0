"""Training monitor: JSON epoch log, best-metric tracking, curve plots,
a text report, optional TensorBoard scalars.

Counterpart of ``fastscnn_tpu/utils/monitor.py``: the same JSON schema
(a list of epoch records), best-model rule ((pixAcc + mIoU) / 2) and
report. matplotlib (the curves) and TensorBoard (``--tensorboard-dir``,
through ``torch.utils.tensorboard``) are imported when first used; where
one is not installed the monitor prints one line and goes on without it
(the JAX version's plot raises at the end of a run without matplotlib).
The JSON log stays the record either way.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["TrainingMonitor"]


class TrainingMonitor:
    def __init__(self, log_path: str, experiment_name: str = "fast_scnn", resume: bool = False,
                 tensorboard_dir: str | None = None):
        """``resume=True`` continues an existing JSON log (a full-state
        resume); a fresh run starts a fresh history. ``tensorboard_dir``
        also writes each record as TensorBoard scalars."""
        self.log_path = log_path
        self.experiment_name = experiment_name
        self.records: list[dict] = []
        self.best = {"metric": -1.0, "epoch": -1}
        self.start_time = time.time()
        self.tensorboard_dir = tensorboard_dir
        self._tb_writer = None
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        if resume and os.path.exists(log_path):
            try:
                with open(log_path) as f:
                    self.records = json.load(f)
                for r in self.records:
                    m = r.get("combined_metric", -1.0)
                    if m > self.best["metric"]:
                        self.best = {"metric": m, "epoch": r["epoch"]}
            except (OSError, ValueError, KeyError, TypeError):
                self.records = []

    def log_epoch(self, epoch: int, train_loss: float, lr: float, pix_acc: float | None = None,
                  miou: float | None = None, samples_per_sec: float | None = None,
                  **extra) -> bool:
        """Append one epoch record; True if this epoch is the new best by
        (pixAcc + mIoU) / 2, the reference's model-selection metric."""
        record = {
            "epoch": epoch,
            "train_loss": float(train_loss),
            "lr": float(lr),
            "elapsed_sec": round(time.time() - self.start_time, 1),
        }
        is_best = False
        if pix_acc is not None and miou is not None:
            combined = (float(pix_acc) + float(miou)) / 2.0
            record.update(pix_acc=float(pix_acc), miou=float(miou), combined_metric=combined)
            if combined > self.best["metric"]:
                self.best = {"metric": combined, "epoch": epoch}
                is_best = True
        if samples_per_sec is not None:
            record["samples_per_sec"] = float(samples_per_sec)
        record.update({k: float(v) for k, v in extra.items()})
        self.records.append(record)
        with open(self.log_path, "w") as f:
            json.dump(self.records, f, indent=2)
        self._tb_log(record)
        return is_best

    def _tb_log(self, record: dict) -> None:
        if self.tensorboard_dir is None:
            return
        if self._tb_writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("warning: --tensorboard-dir set but the tensorboard package is not "
                      "installed; no TensorBoard events (the JSON log is unaffected)")
                self.tensorboard_dir = None
                return
            self._tb_writer = SummaryWriter(self.tensorboard_dir)
        step = int(record["epoch"])
        for key, value in record.items():
            if key != "epoch" and isinstance(value, float):
                self._tb_writer.add_scalar(f"{self.experiment_name}/{key}", value, step)
        self._tb_writer.flush()

    def close(self) -> None:
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None

    def plot_curves(self, out_path: str | None = None) -> str | None:
        """The 4-panel curves (loss, pixAcc, mIoU, lr) as a PNG beside the
        log; None when there is nothing to plot or no matplotlib."""
        if not self.records:
            return None
        try:
            import matplotlib
        except ImportError:
            print("no matplotlib: training curves not plotted (the JSON log holds them)")
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out_path = out_path or os.path.splitext(self.log_path)[0] + "_curves.png"
        epochs = [r["epoch"] for r in self.records]
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        axes[0, 0].plot(epochs, [r["train_loss"] for r in self.records])
        axes[0, 0].set_title("train loss")
        val_records = [r for r in self.records if "pix_acc" in r]
        if val_records:
            ve = [r["epoch"] for r in val_records]
            axes[0, 1].plot(ve, [r["pix_acc"] for r in val_records])
            axes[0, 1].set_title("val pixAcc")
            axes[1, 0].plot(ve, [r["miou"] for r in val_records])
            axes[1, 0].set_title("val mIoU")
        axes[1, 1].plot(epochs, [r["lr"] for r in self.records])
        axes[1, 1].set_title("learning rate")
        for ax in axes.ravel():
            ax.grid(alpha=0.3)
        fig.suptitle(self.experiment_name)
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path

    def report(self) -> str:
        """A text report with the reference's convergence hints."""
        lines = [f"=== Training report: {self.experiment_name} ==="]
        if not self.records:
            return "\n".join(lines + ["no epochs logged"])
        losses = [r["train_loss"] for r in self.records]
        lines.append(f"epochs: {len(self.records)}")
        lines.append(f"final loss: {losses[-1]:.4f} (best {min(losses):.4f})")
        if self.best["epoch"] >= 0:
            lines.append(
                f"best (pixAcc+mIoU)/2: {self.best['metric']:.4f} @ epoch {self.best['epoch']}")
        if len(losses) >= 6:
            recent = losses[-3:]
            earlier = losses[-6:-3]
            if sum(recent) / 3 > sum(earlier) / 3 * 0.995:
                lines.append("hint: loss has plateaued — consider lowering lr or stopping")
            else:
                lines.append("convergence: loss still decreasing")
        if len(losses) >= 2 and losses[-1] > losses[0]:
            lines.append("warning: loss increased over training — lr likely too high")
        return "\n".join(lines)
