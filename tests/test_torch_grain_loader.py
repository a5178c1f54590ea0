"""The port's worker-process loader (``data/grain_loader.py``) against the
JAX package's grain loader, on a small Cityscapes tree (4 train pairs of
40 × 72) with the host augmentation on.

Bounds (exact): each epoch's set of ``(index, image, target)`` records
equals the JAX loader's, with 0 and with 2 worker processes; the
decoded cache's counts come back from the workers; a record that fails
in a worker, and a worker that is killed, raise in the consumer. Every
test runs under a deadline (``deadline`` fixture), so that a hung worker
fails its test instead of stalling the suite.
"""

import os
import signal

import numpy as np
import pytest
from PIL import Image

from fastscnn_tpu.data import get_segmentation_dataset as jax_dataset
from fastscnn_tpu.data.grain_loader import GrainDataLoader as JaxGrainLoader
from fastscnn_tpu.data.grain_loader import _DatasetSource
from fastscnn_tpu_torch.data import decoded_cache, get_segmentation_dataset
from fastscnn_tpu_torch.data.grain_loader import GrainDataLoader, WorkerError

SEED, EPOCHS, BATCH = 3, 2, 2
KW = dict(split="train", mode="train", base_size=40, crop_size=32)


@pytest.fixture(autouse=True)
def deadline():
    """Fail the test after 120 s (SIGALRM in the test's thread)."""
    def expire(signum, frame):
        raise TimeoutError("the loader test ran past its deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture()
def fresh_cache(monkeypatch):
    monkeypatch.setattr(decoded_cache, "_cache_dir", None)
    monkeypatch.setattr(decoded_cache, "_hits", 0)
    monkeypatch.setattr(decoded_cache, "_misses", 0)


@pytest.fixture(scope="module")
def citys(tmp_path_factory):
    root = tmp_path_factory.mktemp("citys")
    rng = np.random.default_rng(0)
    for d in ("leftImg8bit", "gtFine"):
        (root / d / "train" / "c").mkdir(parents=True)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (40, 72, 3), dtype=np.uint8)).save(
            root / "leftImg8bit" / "train" / "c" / f"c_{i:06d}_leftImg8bit.png")
        Image.fromarray(rng.choice([0, 7, 8, 26, 33], size=(40, 72)).astype(np.uint8)).save(
            root / "gtFine" / "train" / "c" / f"c_{i:06d}_gtFine_labelIds.png")
    return str(root)


@pytest.fixture(scope="module")
def jax_epochs(citys):
    """The JAX loader's records of each epoch, as a set of (image, target)
    bytes, and the JAX source's record of each (epoch, index)."""
    ds = jax_dataset("citys", root=citys, **KW)
    batches = list(JaxGrainLoader(ds, batch_size=BATCH, shuffle=True, num_workers=0, seed=SEED,
                                  num_epochs=EPOCHS))
    per = len(batches) // EPOCHS
    sets = [{(a.tobytes(), b.tobytes()) for im, tg in batches[e * per:(e + 1) * per]
             for a, b in zip(im, tg)} for e in range(EPOCHS)]
    records = {(e, i): _DatasetSource(ds, seed=SEED + e)[i]
               for e in range(EPOCHS) for i in range(len(ds))}
    return sets, records


def _check_epochs(loader, batches, jax_epochs):
    sets, records = jax_epochs
    per = len(loader) // EPOCHS
    assert len(batches) == len(loader) == EPOCHS * 2
    for e in range(EPOCHS):
        got = [(int(i), im, tg) for i, im, tg in zip(
            loader.order(e), (im for b in batches[e * per:(e + 1) * per] for im in b[0]),
            (tg for b in batches[e * per:(e + 1) * per] for tg in b[1]))]
        assert {(im.tobytes(), tg.tobytes()) for _, im, tg in got} == sets[e]
        for i, im, tg in got:
            np.testing.assert_array_equal(im, records[(e, i)]["image"])
            np.testing.assert_array_equal(tg, records[(e, i)]["target"])
            assert im.dtype == np.uint8 and tg.dtype == np.int32


@pytest.mark.parametrize("workers", [0, 2])
def test_each_epoch_holds_the_jax_records(citys, jax_epochs, fresh_cache, tmp_path, workers):
    """With the decoded cache on: the workers' misses (the first epoch) and
    hits (the second) add up in this process (one batch in flight, so the
    epochs do not overlap)."""
    decoded_cache.set_cache_dir(str(tmp_path / "cache"))
    loader = GrainDataLoader(get_segmentation_dataset("citys", root=citys, **KW),
                             batch_size=BATCH, shuffle=True, num_workers=workers, seed=SEED,
                             num_epochs=EPOCHS, prefetch=1)
    try:
        batches = list(loader)
    finally:
        loader.close()
    _check_epochs(loader, batches, jax_epochs)
    assert decoded_cache.stats()["misses"] == 8 and decoded_cache.stats()["hits"] == 8


def test_device_aug_records_narrow_in_the_workers(citys, fresh_cache):
    """Native-resolution records (mode 'device-aug') with ``narrow_targets``:
    int8 labels, equal to the plain records, and the same batches as with
    no worker."""
    kw = dict(KW, mode="device-aug")
    batches = []
    for workers in (0, 2):
        loader = GrainDataLoader(get_segmentation_dataset("citys", root=citys, **kw),
                                 batch_size=BATCH, shuffle=True, num_workers=workers,
                                 seed=SEED, narrow_targets=True)
        try:
            batches.append(list(loader))
        finally:
            loader.close()
    plain = get_segmentation_dataset("citys", root=citys, **kw)
    order = GrainDataLoader(plain, batch_size=BATCH, shuffle=True, seed=SEED).order(0)
    for (a_im, a_tg), (b_im, b_tg), idx in zip(*batches, order.reshape(-1, BATCH)):
        assert a_tg.dtype == b_tg.dtype == np.int8
        np.testing.assert_array_equal(a_im, b_im)
        np.testing.assert_array_equal(a_tg, b_tg)
        np.testing.assert_array_equal(a_tg, np.stack([plain[i][1] for i in idx]))


def test_a_failing_record_and_a_killed_worker_raise_in_the_consumer(citys, tmp_path,
                                                                     fresh_cache):
    """A file that does not decode raises WorkerError naming the record;
    killing every worker makes the next wait raise within a few seconds."""
    broken = tmp_path / "citys"
    for d in ("leftImg8bit", "gtFine"):
        os.makedirs(broken / d / "train" / "c")
        for name in os.listdir(os.path.join(citys, d, "train", "c")):
            with open(os.path.join(citys, d, "train", "c", name), "rb") as f:
                (broken / d / "train" / "c" / name).write_bytes(f.read())
    (broken / "leftImg8bit" / "train" / "c" / "c_000002_leftImg8bit.png").write_bytes(b"no png")
    ds = get_segmentation_dataset("citys", root=str(broken), **KW)
    loader = GrainDataLoader(ds, batch_size=BATCH, num_workers=2, seed=SEED)
    try:
        with pytest.raises(WorkerError, match="record 2 of epoch 0"):
            list(loader)
    finally:
        loader.close()

    loader = GrainDataLoader(get_segmentation_dataset("citys", root=citys, **KW),
                             batch_size=BATCH, num_workers=2, seed=SEED, num_epochs=4,
                             prefetch=1)
    it = iter(loader)
    try:
        next(it)
        for p in loader._workers.procs:
            os.kill(p.pid, signal.SIGKILL)
        with pytest.raises(WorkerError, match="died"):
            for _ in it:
                pass
    finally:
        it.close()
        loader.close()
