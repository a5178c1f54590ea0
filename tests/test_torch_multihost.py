"""The port's multi-process plumbing on the CPU: ``parallel/multihost.py``
(the variables, explicit arguments, ``host_shard`` against JAX's,
``run_local_group``'s failures), ``parallel/mesh.py``'s errors against
JAX's, the loaders' and the monitor's per-rank behaviour, ``serving
--data-parallel``, ``tools/multihost_smoke.py`` (2 gloo processes against
a one-process control, the JAX test's envelope) and
``entry.dryrun_multichip(2)``. The steps under a mesh are
``tests/test_torch_multidevice.py``'s.
"""

import io
import json
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fastscnn_tpu.parallel import make_mesh_for_batch as jax_make_mesh_for_batch
from fastscnn_tpu.parallel import multihost as jax_multihost
from fastscnn_tpu_torch import entry
from fastscnn_tpu_torch.data import DataLoader
from fastscnn_tpu_torch.data.grain_loader import GrainDataLoader
from fastscnn_tpu_torch.parallel import make_mesh, make_mesh_for_batch, multihost
from fastscnn_tpu_torch.utils.monitor import TrainingMonitor

DEADLINE_S = 300
NC = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append(kwargs)


@pytest.fixture()
def recorder(monkeypatch):
    import torch.distributed as dist

    rec = _Recorder()
    monkeypatch.setattr(dist, "init_process_group", rec)
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(name, raising=False)
    return rec


def test_multihost_noop_single_process(recorder):
    assert multihost.initialize_multihost() is False and recorder.calls == []
    assert multihost.is_primary_host() and multihost.process_count() == 1
    a, b = np.arange(8), np.arange(16).reshape(8, 2)
    np.testing.assert_array_equal(multihost.host_shard(a), a)
    ra, rb = multihost.host_shard(a, b)
    np.testing.assert_array_equal(rb, b)


def test_multihost_env_var_plumbing(recorder, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert multihost.initialize_multihost(device="cpu") is True
    (call,) = recorder.calls
    assert (call["init_method"], call["world_size"], call["rank"], call["backend"]) == (
        "tcp://10.0.0.1:8476", 4, 2, "gloo")
    assert call["timeout"].total_seconds() == multihost.INIT_TIMEOUT_S


def test_multihost_explicit_args_override_env(recorder, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert multihost.initialize_multihost("10.9.9.9:1234", num_processes=8, process_id=0,
                                          device="cuda") is True
    (call,) = recorder.calls
    assert (call["init_method"], call["world_size"], call["rank"], call["backend"]) == (
        "tcp://10.9.9.9:1234", 8, 0, "nccl")


def test_multihost_process_id_zero_not_dropped(recorder, monkeypatch):
    monkeypatch.setenv("PROCESS_ID", "3")
    assert multihost.initialize_multihost("c:1", num_processes=2, process_id=0, device="cpu",
                                          backend="gloo")
    assert recorder.calls[0]["rank"] == 0


def test_multihost_pod_variable_alone_does_not_join(recorder, monkeypatch):
    """JAX's Cloud TPU pod branch has no GPU counterpart: TPU_WORKER_HOSTNAMES
    alone joins nothing; a partial description raises."""
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host-0,host-1")
    assert multihost.initialize_multihost() is False and recorder.calls == []
    with pytest.raises(ValueError, match="PROCESS_ID"):
        multihost.initialize_multihost("c:1", num_processes=2)


def test_multihost_binds_each_rank_to_its_card(recorder, monkeypatch):
    """With cards visible, rank k's current device after the join is
    cuda:(k % cards), and an NCCL group is bound to it (``device_id``), so
    that the collectives' own tensors land on the rank's card; an explicit
    card is kept, gloo is left unbound and the CPU binds nothing."""
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    for k in range(5):
        assert multihost.initialize_multihost("c:1", num_processes=5, process_id=k)
        card = torch.device("cuda", k % 3)
        assert current[-1] == card
        call = recorder.calls[-1]
        assert (call["backend"], call["device_id"], call["rank"]) == ("nccl", card, k)
    assert multihost.initialize_multihost("c:1", 2, 1, device="cuda:2", backend="gloo")
    assert current[-1] == torch.device("cuda", 2) and "device_id" not in recorder.calls[-1]
    assert multihost.initialize_multihost("c:1", 2, 1, device="cpu")
    assert len(current) == 6 and "device_id" not in recorder.calls[-1]
    assert recorder.calls[-1]["backend"] == "gloo"


def test_trainer_close_releases_graphs_before_leaving_its_group(monkeypatch):
    """``Trainer.close`` (the end of ``train.main``) leaves a group the
    trainer joined only after its graphed steps dropped their captures, and
    touches neither a group the caller joined nor the graphs then."""
    import torch.distributed as dist

    from fastscnn_tpu_torch import train

    calls = []

    class Step:
        def __init__(self, name):
            self.name = name

        def release(self):
            calls.append(self.name)

    monkeypatch.setattr(dist, "destroy_process_group", lambda: calls.append("destroy"))
    trainer = train.Trainer.__new__(train.Trainer)
    trainer.train_step, trainer.eval_step, trainer.joined = Step("train"), Step("eval"), False
    trainer.close()
    assert calls == []
    trainer.joined = True
    trainer.close()
    trainer.close()
    assert calls == ["train", "eval", "destroy"] and not trainer.joined


def test_kernel_launch_runs_on_its_tensors_card(monkeypatch):
    """``_build.launch`` calls a kernel's entry with its device current and
    that device's stream: under a guard for another card, with none for the
    current one (the single-device path)."""
    from types import SimpleNamespace

    from fastscnn_tpu_torch.ops.cuda import _build

    state = {"current": 0, "guards": 0}

    class Guard:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            state["guards"] += 1
            self.prev, state["current"] = state["current"], self.index

        def __exit__(self, *exc):
            state["current"] = self.prev

    def stream(device):
        index = torch.device(device).index
        return SimpleNamespace(cuda_stream=100 + (state["current"] if index is None else index))

    seen = []
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(_build, "library", lambda name: SimpleNamespace(
        entry=lambda *a: seen.append((state["current"], a)) or 0))
    for device in ("cuda:0", "cuda:1", "cuda", "cuda:2"):
        assert _build.launch("dw_conv", "entry", torch.device(device), 5) == 0
    assert seen == [(0, (5, 100)), (1, (5, 101)), (0, (5, 100)), (2, (5, 102))]
    assert state == {"current": 0, "guards": 2}


def test_batch_and_replicate_sharding_match_jax():
    """The engine's split of a batch over the data axis is the rows JAX's
    ``batch_sharding`` gives each device; a replica a place on ``data``."""
    from fastscnn_tpu.parallel import batch_sharding as jax_batch_sharding
    from fastscnn_tpu.parallel import make_mesh as jax_make_mesh
    from fastscnn_tpu_torch.parallel import batch_sharding, replicate_sharding

    for n_data, batch in ((1, 3), (2, 4), (4, 8), (8, 16)):
        jax_mesh = jax_make_mesh(n_data=n_data, devices=jax.devices()[:n_data])
        want = jax_batch_sharding(jax_mesh).devices_indices_map((batch, 2, 2, 3))
        want = [want[d][0] for d in jax_mesh.devices[:, 0]]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mesh = make_mesh(n_data=n_data, devices=["cpu"] * 8)
        got = batch_sharding(mesh, batch)
        assert [range(batch)[s] for s in got] == [range(batch)[s] for s in want], n_data
        assert replicate_sharding(mesh) == (torch.device("cpu"),) * n_data
    with pytest.raises(ValueError, match="must divide the data axis"):
        batch_sharding(make_mesh(n_data=2, devices=["cpu"] * 2), 3)
    assert replicate_sharding(make_mesh(n_space=2, devices=["cuda:0", "cuda:0", "cuda:1",
                                                            "cuda:1"])) == (
        torch.device("cuda", 0), torch.device("cuda", 1))


def test_host_shard_slices_like_jax(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    monkeypatch.setattr(multihost, "_world", lambda: (4, 2))
    a, b = np.arange(8), np.arange(16).reshape(8, 2)
    for got, want in zip(multihost.host_shard(a, b), jax_multihost.host_shard(a, b)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(multihost.host_shard(a), [4, 5])
    assert not multihost.is_primary_host()


def test_make_mesh_errors_and_warning_match_jax():
    cpu8 = ["cpu"] * 8
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_space=3, devices=cpu8)
    with pytest.raises(ValueError, match="empty mesh"):
        make_mesh(n_data=0, n_space=2, devices=cpu8)
    with pytest.raises(ValueError, match="only 2 visible"):
        make_mesh(n_data=3, devices=["cpu"] * 2)
    with pytest.warns(UserWarning, match="mesh uses 2 of 8 visible devices"):
        make_mesh(n_data=2, devices=cpu8)
    mesh = make_mesh(n_space=2, devices=cpu8)
    assert mesh.shape == {"data": 4, "space": 2} and mesh.group is None and mesh.index == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for batch in (1, 2, 3, 6, 8, 12, 16):
            assert make_mesh_for_batch(batch, devices=cpu8).shape == dict(
                jax_make_mesh_for_batch(batch).shape), batch


def test_serving_data_parallel_serves_over_replicas(capsys):
    import urllib.request

    from fastscnn_tpu_torch.serving import build_server

    server = build_server(["--device", "cpu,cpu", "--data-parallel", "2", "--dataset", "custom",
                           "--height", "32", "--width", "48", "--max-batch", "4", "--host",
                           "127.0.0.1", "--port", "0", "--dtype", "float32"])
    try:
        out = capsys.readouterr().out
        assert "warming up batch=4" in out and "batch=1" not in out
        assert server.predictor.bucket_sizes == (4,)
        frame = np.random.default_rng(2).integers(0, 256, (32, 48, 3)).astype(np.uint8)
        body = io.BytesIO()
        Image.fromarray(frame).save(body, "PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict",
                                     data=body.getvalue(), method="POST",
                                     headers={"Accept": "application/octet-stream"})
        resp = urllib.request.urlopen(req, timeout=60)
        mask = np.frombuffer(resp.read(), np.uint8).reshape(32, 48)
        assert set(np.unique(mask)) <= {0, 1}
    finally:
        server.stop()


@pytest.mark.parametrize("argv,message", [
    (["--max-batch", "3", "--data-parallel", "2"], "--max-batch must be divisible"),
    (["--data-parallel", "2"], "only 1 device"),
])
def test_serving_data_parallel_refusals_match_jax(argv, message, capsys):
    from fastscnn_tpu_torch.serving import build_server

    with pytest.raises(SystemExit):
        build_server(["--device", "cpu", *argv])
    assert message in capsys.readouterr().err


def test_multihost_smoke_two_processes_against_a_one_process_control(tmp_path, monkeypatch):
    """tools/multihost_smoke: 2 gloo processes agree bit for bit, and with
    a one-process control on the same global batches (step 0 to f32
    round-off, then within the JAX test's chaos envelope)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    r0, r1 = entry._two_process_stage(torch.device("cpu"), "gloo", DEADLINE_S)
    assert r0["process_count"] == r1["process_count"] == r0["device_count"] == 2
    assert r0["mesh_shape"] == {"data": 2, "space": 1} and r0["final_step"] == 4
    out = str(tmp_path / "ctrl.json")
    multihost.run_local_group(
        lambda k: ["-m", "fastscnn_tpu_torch.tools.multihost_smoke", "--platform", "cpu",
                   "--steps", "4", "--batch", "8", "--size", "32", "--out", out],
        1, DEADLINE_S, join=False)
    with open(out) as f:
        rc = json.load(f)
    assert rc["process_count"] == 1 and rc["mesh_shape"] == {"data": 1, "space": 1}
    np.testing.assert_allclose(r0["losses"][0], rc["losses"][0], rtol=1e-6)
    for k, (a, b) in enumerate(zip(r0["losses"], rc["losses"])):
        assert abs(a - b) < 1e-6 * 50.0 ** k, (k, a, b)
    np.testing.assert_allclose(r0["param_fingerprint"], rc["param_fingerprint"], rtol=5e-3)


def test_dryrun_multichip_two_processes(monkeypatch, capsys):
    """entry.dryrun_multichip(2) on the CPU over gloo (its 2-process stage
    is the multihost_smoke test's)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("FASTSCNN_DRYRUN_MULTIPROC", "0")
    result = entry.dryrun_multichip(2, device="cpu")
    assert result["backend"] == "gloo" and len(result["ranks"]) == 2
    out = capsys.readouterr().out
    assert "dp×sp spatial train step" in out and "bit-equal across the ranks" in out
    assert result["ranks"][0]["space_loss"] == result["ranks"][1]["space_loss"] is not None


def test_a_dead_rank_fails_the_group_within_its_deadline(tmp_path):
    """A rank that exits non-zero kills its peer (blocked in the join) and
    raises with both outputs; so does the deadline."""
    code = ("import os, sys, time\n"
            "from fastscnn_tpu_torch.parallel.multihost import initialize_multihost\n"
            "if os.environ['PROCESS_ID'] == '1': sys.exit(3)\n"
            "initialize_multihost(device='cpu')\n")
    with pytest.raises(RuntimeError, match="process 1 exited with code 3"):
        multihost.run_local_group(lambda k: ["-c", code], 2, 120)
    with pytest.raises(RuntimeError, match="deadline of 2 s"):
        multihost.run_local_group(lambda k: ["-c", "import time; time.sleep(60)"], 1, 2,
                                  join=False)


class _Rows:
    """A dataset whose sample i is (i as an image, i as a label)."""

    num_class = NC

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.uint8), np.full((2, 2), i, np.int32)


@pytest.mark.parametrize("threads", [True, False])
def test_loaders_shard_each_global_batch(threads):
    """With shard=(k, 2) each batch is rank k's contiguous half of the
    global batch that the unsharded loader yields, the same order."""
    def make(shard):
        if threads:
            return DataLoader(_Rows(), batch_size=4, shuffle=True, drop_last=True,
                              num_workers=1, seed=3, shard=shard)
        return GrainDataLoader(_Rows(), batch_size=4, shuffle=True, drop_last=True,
                               num_workers=0, seed=3, shard=shard)

    full = [b[1][:, 0, 0] for b in make(None)]
    halves = [[b[1][:, 0, 0] for b in make((k, 2))] for k in range(2)]
    assert len(full) == 2
    for i, batch in enumerate(full):
        np.testing.assert_array_equal(np.concatenate([halves[0][i], halves[1][i]]), batch)


def test_monitor_of_a_secondary_rank_writes_nothing(tmp_path):
    path = tmp_path / "logs" / "log.json"
    monitor = TrainingMonitor(str(path), write=False)
    assert monitor.log_epoch(0, 1.0, 0.01, pix_acc=0.5, miou=0.25)
    assert monitor.plot_curves() is None and not (tmp_path / "logs").exists()
