"""The serving engine: uint8 NHWC images → BN-folded Fast-SCNN → mask.

Counterpart of ``fastscnn_tpu/engine/infer.py``. The pipeline runs on the
engine's device: normalisation in the compute dtype, the folded network
(``FastSCNN.apply_folded``), then the ×8 bilinear upsample of the 1/8
logits (``align_corners=True``) and the argmax, in the formulation that
``E2EConfig.final_upsample`` names:

- ``'matmul'`` / ``'gather'``: interp-matmul / two-tap lerp upsample of the
  logits, then ``argmax``;
- ``'pallas'``: kernel B1, upsample and argmax fused, no full-resolution
  logits in device memory;
- ``'hybrid'``: W-first interp-matmul, H interp-matmul, ``argmax``;
- ``'hybrid-pallas'``: the same W-first matmul, then kernel B2 for the H
  pass and argmax;
- ``'nbr-exact'``: the low-resolution argmax where an output pixel's 2x2
  source footprint agrees on one class, the ``'hybrid'`` plan elsewhere
  (``neighborhood_agreement_mask``);
- ``'argmax-first'``: argmax at 1/8 resolution, then a nearest ×8
  expansion — a different result by design (mask boundaries on the 8-px
  grid), opt in.

The JAX mode names are kept so configurations map one to one. The
softmax and logits paths use the matmul (or, for ``'gather'``, the lerp)
upsample in every mode.

``predict`` runs eagerly. ``predict_fn(shape)`` and ``throughput_fn``
are the counterparts of the JAX engine's executable per shape: on the
card each is one captured CUDA graph, replayed per call.

Under a ``mesh`` (a local mesh of ``parallel/mesh.py``, as the JAX
engine's ``mesh``) the engine holds one replica of the folded weights on
each device of the mesh's ``data`` axis (a device listed twice holds two):
a batch is split over ``data`` in order, each shard run on its replica
under its device's guard and on that device's current stream, and the
masks gathered in order on the first device. ``predict_fn`` and
``throughput_fn`` capture one graph a replica.

With a ``space`` axis above 1 (JAX's spatial serving) every device of the
mesh holds a replica, and each data place's shard is normalised on the
place's first device, then split into blocks of rows over the place's
space devices, where the backbone runs H-sharded
(``FastSCNN.apply_folded(space=...)``, one thread a device over a local
space group of ``parallel/spatial.py``, each copy between devices on the
stream that wrote its source). The blocks of the 1/8 logits are
gathered on the place's first device, and the mask head runs there as the
meshless engine runs it. The raw input's H must be divisible by the
``space`` axis, as JAX shards it (``P('data', 'space')``); the network's
input after ``internal_size`` may be any H, split in near-equal blocks,
and every level below splits as ``ops/halo.space_rows`` says (unequal or
empty blocks, as GSPMD pads them). The kernel configurations raise JAX's
``ValueError``: kernels B1–B5, B7 and B8 take whole images. Under ``space``
``predict_fn`` and ``throughput_fn`` run eagerly: a CUDA graph is captured
on one thread's stream, and the blocks' threads meet at every exchange.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Callable

import numpy as np
import torch

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.models.fast_scnn import FastSCNN, fold_inference_params
from fastscnn_tpu_torch.ops.cuda.upsample_argmax import (
    neighborhood_agreement_mask,
    upsample_argmax,
    w_matmul_h_lerp_argmax,
)
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_matmul, resize_nearest
from fastscnn_tpu_torch.utils.cuda_graph import capture

__all__ = ["InferenceEngine", "E2EConfig", "IMAGENET_MEAN", "IMAGENET_STD", "FINAL_UPSAMPLE_MODES"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

FINAL_UPSAMPLE_MODES = (
    "matmul", "gather", "pallas", "hybrid", "hybrid-pallas", "nbr-exact", "argmax-first",
)
# eager passes before a capture: they fill the cached tables, let cuDNN
# pick its algorithms, load the kernels' modules and set their
# shared-memory attributes, none of which a capture may do
WARMUP_PASSES = 2


@dataclasses.dataclass(frozen=True)
class E2EConfig:
    """End-to-end graph options; the fields and defaults of the JAX
    package's ``E2EConfig``.

    ``internal_size``: the resolution the backbone runs at (None: the
    input's). ``mean``/``std``: per-channel normalisation after /255
    (None: raw [0, 1]). ``softmax``: return class probabilities at the
    input size instead of a mask. ``final_upsample``: the mask head's
    formulation (see the module docstring). ``mask_dtype``: dtype of the
    returned mask ('int32' or 'uint8')."""

    internal_size: tuple[int, int] | None = None
    mean: tuple[float, ...] | None = None
    std: tuple[float, ...] | None = None
    softmax: bool = False
    compute_dtype: str = "bfloat16"
    final_upsample: str = "hybrid"
    mask_dtype: str = "int32"


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _uses_kernels(model: FastSCNN, config: E2EConfig) -> bool:
    """Whether the configuration runs a serving kernel (the JAX engine's
    ``_uses_pallas``)."""
    return (getattr(model, "folded_dw_impl", "conv") in ("pallas", "fused-ds", "fused-ds-mr")
            or getattr(model, "folded_pw_impl", "conv") != "conv"
            or config.final_upsample in ("pallas", "hybrid-pallas"))


def _mesh_devices(mesh, device) -> list | None:
    """The devices of ``mesh``'s data axis (None without a mesh), after the
    checks the engine makes of a mesh."""
    if mesh is None:
        return None
    # imported here: parallel/ imports this module
    from fastscnn_tpu_torch.parallel.mesh import replicate_sharding

    if mesh.group is not None or mesh.ranks is not None:
        raise ValueError("InferenceEngine serves under a local mesh (one process, a replica a "
                         "device), not a process-group mesh")
    devices = [torch.device(d) for d in replicate_sharding(mesh)]
    if device is not None and torch.device(device) != devices[0]:
        raise ValueError(f"device {device} is not the mesh's first device {devices[0]}")
    return devices


def _device_guard(device):
    """The current CUDA device set to ``device`` for the block (nothing for
    the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class InferenceEngine:
    """Fast-SCNN serving engine on BN-folded weights.

    Usage::

        model = init_fast_scnn(19, generator=torch.Generator().manual_seed(0))
        engine = InferenceEngine(model, config=E2EConfig(mean=IMAGENET_MEAN, std=IMAGENET_STD))
        mask = engine.predict(uint8_images)      # (N, H, W) on the engine's device

    ``device=None`` means the CUDA card (raises when there is none). The
    engine folds the model's weights once, into ``config.compute_dtype``.
    An engine over :func:`~fastscnn_tpu_torch.models.quantized_model`'s
    model is the int8 serving path (calibrate its scales on the 'conv'
    model with :func:`~fastscnn_tpu_torch.models.calibrate_pw_scales`).
    ``infer([nchw])`` is the reference's ``InferSession`` duck-type.

    ``mesh``: a local :class:`~fastscnn_tpu_torch.parallel.mesh.Mesh`
    (module docstring); the engine's ``device`` is then the mesh's first,
    ``predict`` and the graphed callables split each batch over ``data``
    (``ValueError`` when the batch does not divide it), and the other
    methods run on the first replica. Under a ``space`` axis above 1 each
    data place runs its shard H-sharded over its space devices (module
    docstring); a kernel configuration raises JAX's ``ValueError`` there.
    A process-group mesh raises ``ValueError``: serving under a mesh runs
    in one process.
    """

    def __init__(self, model: FastSCNN, device=None, config: E2EConfig = E2EConfig(),
                 mesh=None):
        if config.final_upsample not in FINAL_UPSAMPLE_MODES:
            raise ValueError(f"unknown final_upsample {config.final_upsample!r}")
        n_space = mesh.shape.get("space", 1) if mesh is not None else 1
        if n_space > 1 and _uses_kernels(model, config):
            raise ValueError(
                "Pallas serving kernels (folded_dw_impl="
                f"{getattr(model, 'folded_dw_impl', 'conv')!r}, final_upsample="
                f"{config.final_upsample!r}) cannot be spatially sharded "
                "('space' axis > 1) — use a data-only mesh, or 'conv'/'taps' "
                "+ 'hybrid'/'matmul'"
            )
        devices = _mesh_devices(mesh, device)
        self.mesh = mesh
        self.device = resolve_device(devices[0] if devices else device)
        self.model = model.to(self.device).eval()
        self.config = config
        self._dtype = _torch_dtype(config.compute_dtype)
        self._mask_dtype = _torch_dtype(config.mask_dtype)
        self.folded = fold_inference_params(self.model, self._dtype)
        if config.mean is not None:
            std = config.std if config.std is not None else (1.0,) * 3
            self._mean = torch.tensor(config.mean, dtype=self._dtype, device=self.device)
            self._std = torch.tensor(std, dtype=self._dtype, device=self.device)
        self._inv255 = torch.tensor(1.0 / 255.0, dtype=self._dtype, device=self.device)
        self._fns: dict = {}
        self._fns_lock = threading.Lock()
        # the graphs' shared memory pool and the one side stream of their
        # warm-ups and captures, made at the first capture: the process
        # keeps a cuBLAS workspace for each stream that runs a matmul, so a
        # new stream a capture would keep one more workspace each time
        self._pool = self._stream = None
        # one engine a place on the mesh's data axis, this one first; the
        # others fold their own copy of the weights on their device
        self.replicas = [self] + [self._peer(d) for d in (devices or [])[1:]]
        # under a space axis: each replica's space devices' engines, itself first
        self._space_peers = None
        if n_space > 1:
            for i, r in enumerate(self.replicas):
                r._space_peers = [r] + [self._peer(d) for d in
                                        mesh.devices[i * n_space + 1:(i + 1) * n_space]]

    def _peer(self, device) -> "InferenceEngine":
        """A meshless engine of this one's model and config on ``device``
        (its own copy of the weights there)."""
        same = torch.device(device) == self.device
        return InferenceEngine(self.model if same else copy.deepcopy(self.model), device=device,
                               config=self.config)

    # -- graph pieces -------------------------------------------------------
    def graph_tensors(self) -> dict:
        """The tensors the graph reads besides the images and the resize
        tables: ``folded`` (the BN-folded tree), ``inv255`` and, with
        ``config.mean``, ``mean`` and ``std``. Each graph piece takes such a
        dict as ``g`` (None: this one), so that ``engine/export.py`` can
        pass its module's buffers instead."""
        g = {"folded": self.folded, "inv255": self._inv255}
        if self.config.mean is not None:
            g.update(mean=self._mean, std=self._std)
        return g

    def _preprocess(self, images: torch.Tensor, g: dict | None = None) -> torch.Tensor:
        """uint8/float NHWC [0, 255] → normalised NHWC in the compute dtype,
        with the JAX rounding order: cast, × (1/255), then (x − mean) / std."""
        g = self.graph_tensors() if g is None else g
        x = images.to(self._dtype) * g["inv255"]
        if self.config.internal_size is not None:
            x = resize_bilinear(x, self.config.internal_size, align_corners=False)
        if self.config.mean is not None:
            x = (x - g["mean"]) / g["std"]
        return x

    def _net_in_size(self, shape):
        return tuple(self.config.internal_size or shape[1:3])

    def _net_logits(self, x: torch.Tensor, g: dict) -> torch.Tensor:
        """The 1/8 logits of the normalised batch ``x``; under a ``space``
        axis its blocks of rows run on the space devices (module
        docstring) and the logits' blocks are gathered here."""
        peers = self._space_peers
        if peers is None:
            return self.model.apply_folded(g["folded"], x, upsample_outputs=False)[0]
        from fastscnn_tpu_torch.ops.halo import space_rows
        from fastscnn_tpu_torch.parallel.spatial import copy_after, local_spaces, run_spmd

        n = len(peers)
        rows = space_rows(n, x.shape[1])
        spaces = [sp.at(rows) for sp in local_spaces([p.device for p in peers])]
        # each thread works on the caller's current stream of its device, so
        # that it is ordered after the caller's work and before its reads;
        # every copy between devices runs on the stream that wrote its source
        streams = [torch.cuda.current_stream(p.device) if p.device.type == "cuda" else None
                   for p in peers]

        def rank(k):
            peer = peers[k]
            on_stream = (torch.cuda.stream(streams[k]) if streams[k] is not None
                         else contextlib.nullcontext())
            with _device_guard(peer.device), on_stream, torch.inference_mode():
                block = copy_after(x[:, slice(*rows[k])], streams[0], peer.device)
                folded = g["folded"] if k == 0 else peer.folded
                return peer.model.apply_folded(folded, block, upsample_outputs=False,
                                               space=spaces[k])[0]

        blocks = run_spmd(spaces, rank)
        return torch.cat([copy_after(b, s, self.device) for b, s in zip(blocks, streams)], dim=1)

    def _forward(self, images, resize_back=False, upsample=True, g=None):
        if self._space_peers is not None:  # JAX's P('data', 'space') on the raw input
            from fastscnn_tpu_torch.parallel.mesh import check_spatial_height

            check_spatial_height(images.shape[1], len(self._space_peers))
        g = self.graph_tensors() if g is None else g
        x = self._preprocess(images, g)
        logits = self._net_logits(x, g)
        if upsample and logits.shape[1:3] != x.shape[1:3]:
            up = resize_bilinear if self.config.final_upsample == "gather" else resize_bilinear_matmul
            logits = up(logits, (x.shape[1], x.shape[2]), align_corners=True)
        if resize_back and logits.shape[1:3] != images.shape[1:3]:
            logits = resize_bilinear(
                logits, (images.shape[1], images.shape[2]), align_corners=False
            )
        return logits

    def _mask_at_net_res(self, images, g=None):
        mode = self.config.final_upsample
        size = self._net_in_size(images.shape)
        if mode == "pallas":
            logits = self._forward(images, upsample=False, g=g).contiguous()
            return upsample_argmax(logits, size, align_corners=True)
        if mode in ("hybrid", "hybrid-pallas"):
            return w_matmul_h_lerp_argmax(
                self._forward(images, upsample=False, g=g), size, align_corners=True,
                use_kernel=mode == "hybrid-pallas", out_dtype=self._mask_dtype,
            )
        if mode == "nbr-exact":
            return neighborhood_agreement_mask(
                self._forward(images, upsample=False, g=g), size, align_corners=True,
                out_dtype=self._mask_dtype,
            )
        if mode == "argmax-first":
            mask = self._forward(images, upsample=False, g=g).argmax(dim=-1).to(torch.int32)
            return resize_nearest(mask, size)
        return self._forward(images, g=g).argmax(dim=-1).to(torch.int32)

    def _predict_batch(self, images: torch.Tensor, g: dict | None = None) -> torch.Tensor:
        """The whole of ``predict`` for an (N, H, W, 3) batch on the device."""
        out_size = tuple(images.shape[1:3])
        if self.config.softmax:
            probs = torch.softmax(self._forward(images, g=g).float(), dim=-1)
            if tuple(probs.shape[1:3]) != out_size:
                probs = resize_bilinear(probs, out_size, align_corners=False)
            return probs
        mask = self._mask_at_net_res(images, g)
        if tuple(mask.shape[1:3]) != out_size:
            mask = resize_nearest(mask, out_size)
        return mask.to(self._mask_dtype)

    def _checksum_loop(self, x_in: torch.Tensor, iters: int) -> torch.Tensor:
        """``iters`` forwards of the mask path, each on an input that the
        previous mask changed (the JAX ``throughput_fn``'s chain): the
        first image's pixel (0, 0) gains ``m[0, 0, 0] % 2`` and the
        checksum ``m[0, 0, 0]``, so no forward repeats the one before."""
        out_size = tuple(x_in.shape[1:3])
        x = x_in.clone()
        acc = torch.zeros((), dtype=torch.int32, device=x.device)
        for _ in range(iters):
            m = self._mask_at_net_res(x)
            if tuple(m.shape[1:3]) != out_size:
                m = resize_nearest(m, out_size)
            x[0, 0, 0, 0].add_((m[0, 0, 0] % 2).to(x.dtype))
            acc.add_(m[0, 0, 0])
        return acc

    def _as_input(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        return images.to(self.device)

    def _shards(self, images) -> list:
        """``images`` (numpy or tensor, on any device) split over the mesh's
        ``data`` axis in order, one shard a replica."""
        from fastscnn_tpu_torch.parallel.mesh import batch_sharding

        return [images[rows] for rows in batch_sharding(self.mesh, images.shape[0])]

    def _on_replicas(self, images, call: Callable) -> list:
        """``call(replica, shard)`` for each replica on its shard, each under
        its device's guard (so its kernels launch there, on that device's
        current stream)."""
        outs = []
        for replica, shard in zip(self.replicas, self._shards(images)):
            with _device_guard(replica.device):
                outs.append(call(replica, shard))
        return outs

    def _gather(self, outs: list) -> torch.Tensor:
        """The replicas' results in order, on the first device."""
        return torch.cat([o.to(self.device) for o in outs])

    def _graphed(self, body: Callable, warm: Callable, shape, what: str) -> Callable:
        """``body(static_in)`` captured as one CUDA graph over a static
        uint8 input of ``shape``: :data:`WARMUP_PASSES` eager passes of
        ``warm`` (which launches what ``body`` launches), then the capture
        into the engine's memory pool, both on the engine's side stream. The
        returned ``run(images)`` copies ``images`` (numpy, or a tensor on
        the CPU or the card) into the static input on the current stream,
        replays the graph and returns a copy of the static output made on
        the same stream, so a later replay cannot overwrite a result that a
        caller still holds. ``run.launches`` holds the kernel launches the
        capture made (each replay launches them again; the wrappers' own
        counters see only the capture), ``run.replays`` the replays so far
        and ``run.pool_bytes`` the device memory the capture reserved; the
        graph holds the device tables it reads, and ``run.engine`` the engine,
        whose weights it reads. A failed capture raises
        ``ValueError``."""
        dev = self.device
        if self._pool is None:
            self._pool, self._stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        side = self._stream
        static_in = torch.zeros(shape, dtype=torch.uint8, device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(WARMUP_PASSES):
                warm(static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.inference_mode():
            captured = capture(lambda: body(static_in), dev, self._pool, side)
        static_out = captured.out

        @torch.inference_mode()
        def run(images):
            if isinstance(images, np.ndarray):
                images = torch.from_numpy(np.ascontiguousarray(images))
            if tuple(images.shape) != tuple(shape) or images.dtype != torch.uint8:
                raise ValueError(f"{what} captured for uint8 {tuple(shape)}, got "
                                 f"{images.dtype} {tuple(images.shape)}")
            if images.device.type == "cpu":
                images = images.pin_memory()  # an asynchronous copy, its buffer held until done
            static_in.copy_(images, non_blocking=True)
            captured.replay()
            run.replays += 1
            return static_out.clone()

        run.launches, run.replays, run.pool_bytes = captured.launches, 0, captured.pool_bytes
        # the graph reads the engine's folded weights and constants by address:
        # the callable holds the engine, so a caller that keeps only the
        # callable cannot free them under the graph
        run.engine = self
        return run

    def _eager(self, body: Callable, shape, what: str) -> Callable:
        """``body`` with :meth:`_graphed`'s contract, run eagerly (the CPU)."""

        @torch.inference_mode()
        def run(images):
            images = self._as_input(images)
            if tuple(images.shape) != tuple(shape) or images.dtype != torch.uint8:
                raise ValueError(f"{what} for uint8 {tuple(shape)}, got "
                                 f"{images.dtype} {tuple(images.shape)}")
            run.replays += 1
            return body(images)

        run.launches, run.replays, run.pool_bytes, run.engine = {}, 0, 0, self
        return run

    def _cached(self, key, body: Callable, warm: Callable, shape, what: str) -> Callable:
        with self._fns_lock:
            if key not in self._fns:
                shape = tuple(int(d) for d in shape)
                graphed = self.device.type == "cuda" and self._space_peers is None
                self._fns[key] = (self._graphed(body, warm, shape, what) if graphed
                                  else self._eager(body, shape, what))
            return self._fns[key]

    # -- public API ---------------------------------------------------------
    @torch.inference_mode()
    def predict(self, images) -> torch.Tensor:
        """uint8 NHWC batch (numpy or tensor) → (N, H, W) mask in
        ``mask_dtype`` (or (N, H, W, C) f32 softmax probabilities when
        ``config.softmax``), on the engine's device.

        Eager: every call launches its kernels from Python. The JAX
        ``predict`` goes through its per-shape executables; here that is
        :meth:`predict_fn`, kept apart because a CUDA graph holds its
        activation memory for as long as the engine lives."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        squeeze = images.ndim == 3
        if squeeze:
            images = images[None]
        if len(self.replicas) > 1:
            out = self._gather(self._on_replicas(
                images, lambda r, shard: r._predict_batch(r._as_input(shard))))
        else:
            out = self._predict_batch(self._as_input(images))
        return out[0] if squeeze else out

    def predict_fn(self, shape) -> Callable:
        """The callable for uint8 batches of ``shape`` (N, H, W, 3), cached
        per shape: it takes a batch (numpy or tensor) of exactly that shape
        and returns what :meth:`predict` returns, as a new tensor on the
        engine's device. On the card it is one captured CUDA graph of the
        whole of ``predict`` (see :meth:`_graphed`; its graphs share one
        memory pool, so replays must be issued from one stream at a time,
        as ``serving.BatchingPredictor``'s dispatcher does); on the CPU,
        and under a ``space`` axis (module docstring), it runs eagerly."""
        def local(r, s):
            return r._cached(("predict", tuple(s)), r._predict_batch, r._predict_batch, s,
                             "predict_fn")

        if len(self.replicas) > 1:
            return self._sharded_fn(("mesh", "predict", tuple(shape)), shape, local,
                                    self._gather)
        return local(self, shape)

    def throughput_fn(self, shape, iters: int = 30) -> Callable:
        """A callable that runs ``iters`` mask forwards of a uint8 batch of
        ``shape`` back to back and returns their checksum as an int32
        scalar on the device (the JAX ``throughput_fn``: each forward's
        mask perturbs the next forward's input, so every iteration is real
        work). On the card it is one captured CUDA graph holding all
        ``iters`` forwards: a replay times the device, not the host's
        launches. On the CPU and under a ``space`` axis it runs eagerly."""
        def local(r, s):
            return r._cached(("throughput", tuple(s), int(iters)),
                             lambda x: r._checksum_loop(x, int(iters)),
                             lambda x: r._checksum_loop(x, 1), s, "throughput_fn")

        if len(self.replicas) > 1:
            return self._sharded_fn(("mesh", "throughput", tuple(shape), int(iters)), shape,
                                    local, lambda outs: sum(o.to(self.device) for o in outs))
        return local(self, shape)

    def _sharded_fn(self, key, shape, fn_of: Callable, combine: Callable) -> Callable:
        """Under a mesh: each replica's own callable for its shard of
        ``shape`` (one graph a replica on the card), called on its shard
        under its device's guard, the results combined; the counts
        (``launches``, ``replays``, ``pool_bytes``) are the replicas'
        together."""
        with self._fns_lock:
            if key in self._fns:
                return self._fns[key]
        shape = tuple(int(d) for d in shape)
        from fastscnn_tpu_torch.parallel.mesh import batch_sharding

        rows = batch_sharding(self.mesh, shape[0])[0]
        part = (rows.stop - rows.start, *shape[1:])
        fns = []
        for r in self.replicas:
            with _device_guard(r.device):
                fns.append(fn_of(r, part))

        def run(images):
            outs = []
            for f, r, shard in zip(fns, self.replicas, self._shards(images)):
                with _device_guard(r.device):
                    outs.append(f(shard))
            run.replays += 1
            return combine(outs)

        launches: dict = {}
        for f in fns:
            for k, v in f.launches.items():
                launches[k] = launches.get(k, 0) + v
        run.launches, run.replays, run.engine = launches, 0, self
        run.pool_bytes = sum(f.pool_bytes for f in fns)
        with self._fns_lock:
            return self._fns.setdefault(key, run)

    @torch.inference_mode()
    def logits(self, images) -> torch.Tensor:
        """Logits at the INPUT resolution (resized back when an internal
        backbone resolution is configured) — the ``.infer()`` seam."""
        return self._forward(self._as_input(images), resize_back=True)

    def infer(self, feeds: list) -> list:
        """[NCHW float array in [0, 255]] → [NCHW logits as numpy] — the
        reference's ``InferSession.infer`` duck-type."""
        x = np.asarray(feeds[0])
        logits = self.logits(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))
        return [logits.float().permute(0, 3, 1, 2).cpu().numpy()]
