"""Training CLI on the port: counterpart of ``fastscnn_tpu/train.py``.

The same flags, defaults, checkpoint names, validation cadence and
best-model rule, plus ``--device`` (default: the CUDA card; ``cpu`` runs
every kernel wrapper's plain version). One train step a batch
(``parallel/train.py``): uint8 batches go to the device, are normalised
there, bf16 compute over f32 masters, poly LR by iteration. On the card
the train and eval steps are CUDA graphs, the counterpart of the JAX
trainer's ``jit``: one capture per input shape (an epoch has one, the
loader dropping the last partial batch; datasets of several native sizes
through ``--device-aug`` capture once a size), then replays; a capture
that fails raises. On the CPU both steps run eagerly. A run resumed from
a full train state continues the uninterrupted run exactly: the loader
starts at the restored epoch, and every step's dropout and augmentation
generators are seeded from the seed and the step (the JAX trainer
restarts its key stream and its loader's order at a resume).

Usage::

    python -m fastscnn_tpu_torch.train --dataset citys --base-size 1024 \\
        --crop-size 768 --epochs 160 --batch-size 16 --loss-type ce \\
        --aux --stem-impl pallas --device-aug --decoded-cache /tmp/citys-cache

No PIL is needed on any dataset: the host decodes PNGs with
``data/image_io.py`` and the JPEGs of TuSimple, BDD100K and custom trees
with the port's JPEG codec (``data/jpeg.py``), or copies either out of
``--decoded-cache``, and the host augmentation and validation's ``val``
mode run PIL's operations in numpy (``data/pil_ops.py``).
``--loader grain`` makes the records in worker processes
(``data/grain_loader.py``, no grain). ``--resume`` takes the JAX
trainer's files as well as the port's: ``.pth`` and ``.pth.npz`` load as
weights, any other ``.npz`` as the JAX trainer's full state, ``.pt`` as
the port's.
"""

from __future__ import annotations

import argparse
import os
import time
import warnings

import numpy as np

__all__ = ["parse_args", "Trainer", "main"]


def parse_args(argv=None):
    """The JAX trainer's flags (reference:train.py:21-97 plus the bdd100k
    and custom pass-throughs), and ``--device``."""
    parser = argparse.ArgumentParser(description="Fast-SCNN training on the PyTorch/CUDA port")
    parser.add_argument("--model", type=str, default="fast_scnn")
    parser.add_argument("--dataset", type=str, default="citys",
                        choices=["citys", "tusimple", "bdd100k", "custom"])
    parser.add_argument("--data-root", type=str, default=None, help="dataset root folder")
    parser.add_argument("--base-size", type=int, default=1024)
    parser.add_argument("--crop-size", type=int, default=768)
    parser.add_argument("--train-split", type=str, default="train")
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--aux-weight", type=float, default=0.4)
    parser.add_argument("--epochs", type=int, default=160)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="split each batch into N microbatches run in sequence (activation "
                             "memory / N; the mean of their gradients, one optimizer update)")
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight-decay", type=float, default=1e-4)
    parser.add_argument("--optimizer", type=str, default="sgd", choices=["sgd", "adamw"])
    parser.add_argument("--loss-type", type=str, default="dice",
                        choices=["dice", "focal_dice", "ce", "ce_plain"])
    parser.add_argument("--fp16", action=argparse.BooleanOptionalAction, default=True,
                        help="bf16 compute over f32 masters (--no-fp16 trains in f32)")
    parser.add_argument("--resume", type=str, default=None,
                        help=".pth or .pth.npz (weights), .npz (the JAX trainer's full state) "
                             "or .pt (the port's full train state)")
    parser.add_argument("--auto-resume", action="store_true", default=False,
                        help="resume from save-folder's train_state_<dataset>.pt if present")
    parser.add_argument("--save-folder", type=str, default="./weights")
    parser.add_argument("--tensorboard-dir", type=str, default=None,
                        help="also write epoch metrics as TensorBoard scalars to this directory")
    parser.add_argument("--eval", action="store_true", default=False)
    parser.add_argument("--no-val", action="store_true", default=False)
    parser.add_argument("--val-epoch", type=int, default=1, help="validate every N epochs")
    parser.add_argument("--save-epoch", type=int, default=10)
    parser.add_argument("--print-interval", type=int, default=10)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--loader", type=str, default="threads", choices=["threads", "grain"],
                        help="input pipeline: threaded prefetch (default) or 'grain': worker "
                             "processes, each record's augmentation seeded from (seed, epoch, "
                             "index) (data/grain_loader.py; grain itself is not used)")
    parser.add_argument("--decoded-cache", type=str, default=None, metavar="DIR",
                        help="decode-once image cache directory (data/decoded_cache.py): the "
                             "first epoch decodes and stores arrays, later epochs copy them")
    parser.add_argument("--device-aug", action="store_true", default=False,
                        help="run the augmentation chain on the device inside the train step "
                             "(data/device_aug.py); the host only decodes native-resolution "
                             "images")
    parser.add_argument("--device-aug-split", action="store_true", default=False,
                        help="with --device-aug: augment the whole batch, then run the "
                             "crop-fed step (the native batch freed in between)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stem-impl", type=str, default="xla",
                        choices=["xla", "tapbwd", "taps", "taps-packbn", "pallas"],
                        help="training-time impl of the small-C stem convs ('pallas': the "
                             "depthwise convs through kernel B6)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    # bdd100k extras (reference:train_bdd100k.py)
    parser.add_argument("--subset", type=str, default="100k")
    parser.add_argument("--label-type", type=str, default="binary")
    parser.add_argument("--sample-ratio", type=float, default=1.0)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--keep-original-size", action="store_true", default=False)
    parser.add_argument("--multi-scale", action="store_true", default=False)
    parser.add_argument("--experiment", action="store_true", default=False,
                        help="quick experiment mode: 5%% of the data, 20 epochs, bs 4 "
                             "(reference:train_bdd100k.py:99-107)")
    args = parser.parse_args(argv)
    if args.experiment:
        args.sample_ratio = 0.05
        args.epochs = 20
        args.batch_size = 4
        args.val_epoch = 2
        args.print_interval = 10
    return args


# a step's generator seeds: (seed + k) * stride + step, k = 1 for dropout and
# 2 for the augmentation; distinct for every seed below 2**40 and step below
# the stride
_STEP_SEED_STRIDE = 1_000_003

_DEFAULT_ROOTS = {
    "citys": "./datasets/citys",
    "tusimple": "./manideep1108/tusimple/versions/5/TUSimple",
    "bdd100k": "./bdd100k",
    "custom": "./data/custom",
}


def _device_augment(args, train_ds, compute_dtype):
    """The dataset's augmentation chain (``DEVICE_AUG_CHAIN``, PSP by default)."""
    from fastscnn_tpu_torch.data import device_aug

    chain = getattr(train_ds, "DEVICE_AUG_CHAIN", "psp")
    if chain == "original":
        # BDD100K --keep-original-size: flip + blur (p = 0.3) at the native size
        return device_aug.make_device_augment_original(blur_p=0.3, compute_dtype=compute_dtype)
    if chain == "custom":
        return device_aug.make_device_augment_custom(
            crop_size=args.crop_size, multi_scale=args.multi_scale,
            scales=tuple(train_ds.scales), keep_original_size=args.keep_original_size,
            base_size=args.base_size, compute_dtype=compute_dtype)
    return device_aug.make_device_augment(
        base_size=args.base_size, crop_size=args.crop_size,
        pad_label=train_ds.DEVICE_AUG_PAD_LABEL, compute_dtype=compute_dtype)


class _EpochChunker:
    """The JAX trainer's adapter: a loader's one stream of ``num_epochs``
    epochs, taken an epoch at a time by the training loop."""

    def __init__(self, loader, num_epochs):
        self._loader = loader
        self._iter = iter(loader)
        self._per_epoch = len(loader) // max(num_epochs, 1)
        if self._per_epoch == 0 and len(loader):
            raise ValueError(f"loader yields {len(loader)} total batches for {num_epochs} "
                             "epochs — fewer than one batch per epoch; reduce --epochs or "
                             "--batch-size")

    def __len__(self):
        return self._per_epoch

    def __iter__(self):
        for _ in range(self._per_epoch):
            try:
                yield next(self._iter)
            except StopIteration:
                return

    def close(self):
        self._iter.close()
        self._loader.close()


class Trainer:
    """The training run of ``args`` (:func:`parse_args`). ``graph``: run
    the train and eval steps as CUDA graphs; None (the CLI's only
    setting) means on the card, and the CPU runs them eagerly."""

    def __init__(self, args, graph: bool | None = None):
        import torch

        from fastscnn_tpu_torch import resolve_device
        from fastscnn_tpu_torch.data import DataLoader, decoded_cache, get_segmentation_dataset
        from fastscnn_tpu_torch.engine.infer import IMAGENET_MEAN, IMAGENET_STD
        from fastscnn_tpu_torch.losses import get_loss_fn
        from fastscnn_tpu_torch.models import init_fast_scnn
        from fastscnn_tpu_torch.parallel import (
            create_train_state,
            make_eval_step,
            make_optimizer,
            make_split_aug_train_step,
            make_train_step,
        )
        from fastscnn_tpu_torch.utils import lr_schedule
        from fastscnn_tpu_torch.utils.checkpoint import load_pth_checkpoint, load_train_state
        from fastscnn_tpu_torch.utils.monitor import TrainingMonitor

        self.args = args
        if args.device_aug_split and not args.device_aug:
            warnings.warn("--device-aug-split has no effect without --device-aug: training "
                          "with the host augmentation", stacklevel=2)
        self.device = resolve_device(args.device)
        self.graph = self.device.type == "cuda" if graph is None else graph
        if args.decoded_cache:
            decoded_cache.set_cache_dir(args.decoded_cache)
        root = args.data_root or _DEFAULT_ROOTS[args.dataset]
        ds_kwargs = dict(root=root, base_size=args.base_size, crop_size=args.crop_size)
        if args.dataset == "bdd100k":
            ds_kwargs.update(subset=args.subset, label_type=args.label_type,
                             sample_ratio=args.sample_ratio, max_samples=args.max_samples,
                             keep_original_size=args.keep_original_size,
                             multi_scale=args.multi_scale)
        train_mode = "device-aug" if args.device_aug else "train"
        self.train_ds = get_segmentation_dataset(args.dataset, split=args.train_split,
                                                 mode=train_mode, **ds_kwargs)
        self.val_ds = None
        if not args.no_val:
            val_kwargs = dict(ds_kwargs)
            if args.dataset == "bdd100k" and val_kwargs.get("sample_ratio", 1.0) < 1.0:
                # a smaller validation set, as the reference (train_bdd100k.py:139-141)
                val_kwargs["sample_ratio"] = min(0.2, val_kwargs["sample_ratio"] * 2)
            self.val_ds = get_segmentation_dataset(args.dataset, split="val", mode="val",
                                                   **val_kwargs)
        self.num_classes = self.train_ds.num_class
        if self.train_ds.normalization == "imagenet":
            mean, std = IMAGENET_MEAN, IMAGENET_STD
        else:
            mean, std = None, None

        self.model = init_fast_scnn(self.num_classes, aux=args.aux,
                                    generator=torch.Generator().manual_seed(args.seed),
                                    device="cpu", stem_impl=args.stem_impl)
        self.iters_per_epoch = max(len(self.train_ds) // args.batch_size, 1)
        self.schedule = lr_schedule("poly", base_lr=args.lr, nepochs=args.epochs,
                                    iters_per_epoch=self.iters_per_epoch, power=0.9)
        optimizer = make_optimizer(args.optimizer, self.schedule, momentum=args.momentum,
                                   weight_decay=args.weight_decay)
        self.state = create_train_state(self.model, optimizer, device=self.device)
        if args.auto_resume and not args.resume:
            candidate = os.path.join(args.save_folder, f"train_state_{args.dataset}.pt")
            if os.path.exists(candidate):
                args.resume = candidate
        resumed_run = False  # continuing the same run (a full-state restore)?
        if args.resume:
            if args.resume.endswith((".pth", ".pth.npz")):
                params, mstate = load_pth_checkpoint(args.resume, self.num_classes,
                                                     aux=args.aux or None,
                                                     allow_shape_mismatch=True)
                self.state = create_train_state(self.model, optimizer, params=params,
                                                model_state=mstate, device=self.device)
                print(f"resumed weights from {args.resume}")
            else:  # .pt: the port's full state; any other .npz: the JAX trainer's
                self.state = load_train_state(args.resume, self.state)
                resumed_run = True
                # continue from the epoch the restored step implies
                args.start_epoch = max(args.start_epoch, self.state.step // self.iters_per_epoch)
                print(f"resumed full train state from {args.resume} (step {self.state.step})")

        # native-resolution labels travel as int8 where their range fits; the
        # augmentation gives the loss int32 crops. The loaders start at the
        # start epoch, so a resumed run batches its epochs as the
        # uninterrupted run did
        loader_kwargs = dict(batch_size=args.batch_size, shuffle=True, drop_last=True,
                             num_workers=args.num_workers, seed=args.seed,
                             narrow_targets=args.device_aug, first_epoch=args.start_epoch)
        if args.loader == "grain":
            from fastscnn_tpu_torch.data.grain_loader import GrainDataLoader

            # one stream of every epoch left, cut into epochs for the loop below
            epochs = max(args.epochs - args.start_epoch, 0)
            self.train_loader = _EpochChunker(
                GrainDataLoader(self.train_ds, num_epochs=epochs, **loader_kwargs), epochs)
        else:
            self.train_loader = DataLoader(self.train_ds, **loader_kwargs)

        loss_fn = get_loss_fn(args.loss_type, aux=args.aux, aux_weight=args.aux_weight,
                              num_classes=self.num_classes)
        compute_dtype = torch.bfloat16 if args.fp16 else torch.float32
        step_kwargs = dict(mean=mean, std=std, compute_dtype=compute_dtype,
                           grad_accum=args.grad_accum, device=self.device, graph=self.graph)
        if train_mode == "device-aug":
            device_aug = _device_augment(args, self.train_ds, compute_dtype)
            if args.device_aug_split:
                self.train_step = make_split_aug_train_step(self.model, loss_fn, optimizer,
                                                            device_aug, **step_kwargs)
            else:
                self.train_step = make_train_step(self.model, loss_fn, optimizer,
                                                  device_aug=device_aug, **step_kwargs)
        else:
            self.train_step = make_train_step(self.model, loss_fn, optimizer, **step_kwargs)
        self.eval_step = make_eval_step(self.model, self.num_classes, mean=mean, std=std,
                                        compute_dtype=compute_dtype, device=self.device,
                                        graph=self.graph)
        os.makedirs("logs", exist_ok=True)
        # the history continues only for the same run (a full-state restore):
        # a weights-only .pth resume is transfer learning
        self.monitor = TrainingMonitor(f"logs/training_log_{args.dataset}.json",
                                       experiment_name=f"fast_scnn_{args.dataset}",
                                       resume=resumed_run, tensorboard_dir=args.tensorboard_dir)
        # dropout and augmentation each draw from a generator of their own,
        # reseeded before every step (_seed_step)
        self.dropout_generator = torch.Generator(device=self.device)
        self.aug_generator = torch.Generator(device=self.device)

    # -- loops ---------------------------------------------------------------
    def _seed_step(self):
        """Seed the dropout and augmentation generators from the seed and
        the step about to run, so that a resumed run draws what the
        uninterrupted run drew (a graphed step replays from the seed its
        registered generators hold at the call)."""
        seed, step = self.args.seed, self.state.step
        self.dropout_generator.manual_seed((seed + 1) * _STEP_SEED_STRIDE + step)
        self.aug_generator.manual_seed((seed + 2) * _STEP_SEED_STRIDE + step)

    def train(self):
        try:
            return self._train_loop()
        finally:
            self.monitor.close()
            if isinstance(self.train_loader, _EpochChunker):
                self.train_loader.close()

    def _train_loop(self):
        args = self.args
        for epoch in range(args.start_epoch, args.epochs):
            epoch_losses = []
            metrics = None
            t_epoch = time.time()
            t_data = 0.0
            t_last = time.time()
            for it, (images, targets) in enumerate(self.train_loader):
                t_data += time.time() - t_last
                self._seed_step()
                self.state, metrics = self.train_step(self.state, images, targets,
                                                      self.dropout_generator, self.aug_generator)
                if (it + 1) % args.print_interval == 0:
                    loss = float(metrics["loss"])
                    epoch_losses.append(loss)
                    done = time.time() - t_epoch
                    sps = (it + 1) * args.batch_size / done
                    lr_now = self.schedule(self.state.step)
                    print(f"epoch {epoch} iter {it + 1}/{self.iters_per_epoch} "
                          f"loss {loss:.4f} lr {lr_now:.5f} {sps:.1f} samples/s "
                          f"(data {t_data / (it + 1) * 1e3:.0f} ms/iter)", flush=True)
                t_last = time.time()
            if metrics is None:
                raise RuntimeError(f"epoch {epoch} produced no batches — dataset smaller than "
                                   "one batch with drop_last, or an exhausted loader")
            epoch_loss = (float(np.mean(epoch_losses)) if epoch_losses
                          else float(metrics["loss"]))
            sps = self.iters_per_epoch * args.batch_size / (time.time() - t_epoch)

            pix_acc = miou = None
            if self.val_ds is not None and (epoch + 1) % args.val_epoch == 0:
                pix_acc, miou = self.validation()
                print(f"epoch {epoch}: val pixAcc {pix_acc * 100:.3f}% mIoU {miou * 100:.3f}%")
            is_best = self.monitor.log_epoch(epoch, epoch_loss, self.schedule(self.state.step),
                                             pix_acc=pix_acc, miou=miou, samples_per_sec=sps)
            if is_best or (epoch + 1) % args.save_epoch == 0 or epoch == args.epochs - 1:
                self.save_checkpoint(is_best)
        self.monitor.plot_curves()
        print(self.monitor.report())
        if self.graph:
            print(self.graph_report())
        return self.state

    def graph_report(self) -> str:
        """The graphed steps' captures and memory pools, one line."""
        return ", ".join(
            f"{name} step {len(step.graphs)} CUDA graph captures, {step.replays} replays, "
            f"pool {step.pool_bytes} bytes"
            for name, step in (("train", self.train_step), ("eval", self.eval_step)))

    def validation(self, max_batches: int | None = None):
        from fastscnn_tpu_torch.data import DataLoader
        from fastscnn_tpu_torch.utils.metric import seg_scores_from_hist

        loader = DataLoader(self.val_ds, batch_size=1, num_workers=self.args.num_workers)
        totals = None
        for i, (images, targets) in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            _, stats = self.eval_step(self.state.params, self.state.model_state, images, targets)
            stats = [s.cpu().numpy().astype(np.int64) for s in stats]
            totals = stats if totals is None else [a + b for a, b in zip(totals, stats)]
        if totals is None:
            return 0.0, 0.0
        return seg_scores_from_hist(*totals)

    def save_checkpoint(self, is_best=False):
        from fastscnn_tpu_torch.utils.checkpoint import save_pth_checkpoint, save_train_state

        args = self.args
        path = save_pth_checkpoint(self.state.params, self.state.model_state, args.save_folder,
                                   dataset=args.dataset, is_best=is_best)
        save_train_state(self.state,
                         os.path.join(args.save_folder, f"train_state_{args.dataset}.pt"))
        return path


def main(argv=None):
    args = parse_args(argv)
    trainer = Trainer(args)
    if args.eval:
        pix_acc, miou = trainer.validation()
        print(f"val pixAcc {pix_acc * 100:.3f}% mIoU {miou * 100:.3f}%")
        return trainer
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
