"""The port's profiling surface against the JAX package's:
``utils/profiling.py``'s ``enable_compilation_cache`` (the four cases of
``tests/test_profiling.py``, each run in both packages, the host
fingerprint equal) and ``device_trace``, and ``tools/xplane.py``'s
``device_op_table`` on one synthetic trace written in both forms (an
XSpace protobuf for JAX, Chrome-trace JSON for the port): the same rows
(name, count, time, bytes, operations) and the same device total, exactly.

The JAX side of the trace test runs in a subprocess: importing
``tensorflow.tsl`` takes seconds and would load tensorflow into the test
worker. It skips only where tensorflow is not installed.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from fastscnn_tpu.utils import profiling as jax_profiling
from fastscnn_tpu_torch.ops.cuda import _build
from fastscnn_tpu_torch.tools import xplane
from fastscnn_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fresh_caches(monkeypatch, tmp_path):
    """Both packages' latches reset, the opt-out unset, the kernel build
    directory and JAX's cache directory restored afterwards."""
    import jax

    monkeypatch.setattr(jax_profiling, "_CACHE_ENABLED", [])
    monkeypatch.setattr(profiling, "_CACHE_ENABLED", [])
    monkeypatch.setattr(_build, "_build_dir", [_build.BUILD_DIR])
    monkeypatch.delenv("FASTSCNN_NO_COMPILATION_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    yield tmp_path
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("case", ["host_namespaced", "idempotent", "opt_out_env",
                                  "same_host_same_fingerprint"])
def test_enable_compilation_cache_matches_jax(fresh_caches, monkeypatch, case):
    def run(module, base):
        if case == "host_namespaced":
            got = module.enable_compilation_cache(base)
            assert got is not None and os.path.isdir(got) and os.path.dirname(got) == base
            return os.path.basename(got)
        if case == "idempotent":
            first = module.enable_compilation_cache(base)
            return module.enable_compilation_cache("/nonexistent/other") == first
        if case == "opt_out_env":
            monkeypatch.setenv("FASTSCNN_NO_COMPILATION_CACHE", "1")
            try:
                return module.enable_compilation_cache(base)
            finally:
                monkeypatch.delenv("FASTSCNN_NO_COMPILATION_CACHE")
        first = module.enable_compilation_cache(base)
        monkeypatch.setattr(module, "_CACHE_ENABLED", [])
        return first == module.enable_compilation_cache(base)

    ref = run(jax_profiling, str(fresh_caches / "xla"))
    got = run(profiling, str(fresh_caches / "kernels"))
    assert got == ref
    if case in ("host_namespaced", "idempotent", "same_host_same_fingerprint"):
        # the cache the port enables is where its kernels build and load from
        assert str(_build.build_dir()) == profiling.enable_compilation_cache()
        assert _build._target("dw_conv").parent == _build.build_dir()
    else:
        assert _build.build_dir() == _build.BUILD_DIR


def test_the_default_cache_is_under_the_ignored_build_directory(fresh_caches):
    got = profiling.enable_compilation_cache()
    assert os.path.dirname(got) == str(_build.BUILD_DIR)
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_device_trace_writes_what_xplane_reads(tmp_path, capsys):
    """On the CPU the trace holds the host's operators and no device
    kernel: the table is empty and its total 0; the CLI says so."""
    import torch

    with profiling.device_trace(str(tmp_path / "t")):
        x = torch.randn(32, 32)
        (x @ x).relu().sum()
    (path,) = list((tmp_path / "t").glob("*" + profiling.TRACE_SUFFIX))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e.get("name") == "aten::mm" for e in events)
    rows, total, found = xplane.device_op_table(str(tmp_path))
    assert (rows, total, found) == ([], 0.0, str(path))
    xplane.main([str(tmp_path), "--roofline"])
    out = capsys.readouterr().out
    assert "device total: 0.00 ms/iter over 0 kernels" in out
    assert "no device kernels with cost figures" in out
    with pytest.raises(FileNotFoundError):
        xplane.device_op_table(str(tmp_path / "empty"))


def test_warm_profile_records_the_block_alone():
    """``warm_profile``'s profiler holds the block's operators, once each,
    and none run before it; on the CPU its warm-up step launches nothing,
    and ``device_kernels`` lists no kernel (the step annotation is not one)."""
    import torch

    x = torch.randn(16, 16)
    torch.sigmoid(x)  # before the block: not recorded
    with profiling.warm_profile() as prof:
        (x @ x).relu().sum()
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["aten::mm"] == counts["aten::relu"] == counts["aten::sum"] == 1
    assert "aten::sigmoid" not in counts
    assert any(k.startswith("ProfilerStep") for k in counts)  # the schedule's annotation
    assert profiling.device_kernels(prof) == []  # no kernel on the CPU, the annotation left out


# one synthetic device trace: (name, duration in ps, bytes, flops) of each
# device op, in time order; kernels named as CUPTI reports them
OPS = [
    ("void ds_conv3x3_pw_kernel<__nv_bfloat16>(...)", 43_000_000, 0, 0),
    ("void upsample_argmax_kernel<__nv_bfloat16>(...)", 17_800_000, 0, 0),
    ("ampere_sgemm_32x32_sliced1x4_nn", 12_345_000, 3_000_000, 40_000_000),
    ("void ds_conv3x3_pw_kernel<__nv_bfloat16>(...)", 20_400_000, 0, 0),
    ("void at::native::vectorized_elementwise_kernel<4>(...)", 1_001_000, 0, 0),
    ("ampere_sgemm_32x32_sliced1x4_nn", 12_000_000, 3_000_000, 40_000_000),
    ("void upsample_argmax_kernel<__nv_bfloat16>(...)", 17_700_000, 0, 0),
]
# host work and transfers, which neither table counts
HOST_OPS = [("aten::conv2d", 90_000_000), ("cudaLaunchKernel", 4_000_000)]


def _chrome_trace(path):
    events, ts = [], 1000.0
    for name, ps in HOST_OPS:
        events.append({"ph": "X", "cat": "cpu_op" if "::" in name else "cuda_runtime",
                       "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": ps / 1e6})
    for name, ps, nbytes, flops in OPS:
        args = {"device": 0, "stream": 7}
        if nbytes:
            args.update(bytes_accessed=nbytes, flops=flops)
        events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
                       "dur": ps / 1e6, "args": args})
        ts += ps / 1e6 + 1
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
                   "pid": 0, "tid": 7, "ts": ts, "dur": 250.0})
    events.append({"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0,
                   "tid": 7, "ts": ts + 300, "dur": 3.0})
    events.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 1, "tid": 1,
                   "ts": 1000.0})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))


_XSPACE = """
import json, os, sys
from tensorflow.tsl.profiler.protobuf import xplane_pb2
from fastscnn_tpu.tools.xplane import device_op_table
ops, host_ops, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
space = xplane_pb2.XSpace()
host = space.planes.add(name="/host:CPU")
hl = host.lines.add(name="python")
for i, (name, ps) in enumerate(host_ops):
    host.event_metadata[i + 1].name = name
    hl.events.add(metadata_id=i + 1, duration_ps=ps)
dev = space.planes.add(name="/device:TPU:0")
dev.stat_metadata[1].name = "bytes_accessed"
dev.stat_metadata[2].name = "flops"
modules, xla_ops = dev.lines.add(name="XLA Modules"), dev.lines.add(name="XLA Ops")
modules.events.add(metadata_id=999, duration_ps=sum(p for _, p, _, _ in ops))
dev.event_metadata[999].name = "jit_predict"
ids = {}
for name, ps, nbytes, flops in ops:
    mid = ids.setdefault(name, len(ids) + 1)
    dev.event_metadata[mid].name = name
    ev = xla_ops.events.add(metadata_id=mid, duration_ps=ps)
    if nbytes:
        ev.stats.add(metadata_id=1, int64_value=nbytes)
        ev.stats.add(metadata_id=2, int64_value=flops)
os.makedirs(os.path.join(out, "plugins", "profile", "run"))
with open(os.path.join(out, "plugins", "profile", "run", "host.xplane.pb"), "wb") as f:
    f.write(space.SerializeToString())
rows, total, _ = device_op_table(out)
print(json.dumps([rows, total]))
"""


@pytest.mark.skipif(importlib.util.find_spec("tensorflow") is None,
                    reason="the JAX tool reads XPlane through tensorflow, not installed")
def test_device_op_table_matches_jax_on_one_trace(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT), TF_CPP_MIN_LOG_LEVEL="3")
    proc = subprocess.run(
        [sys.executable, "-c", _XSPACE, json.dumps(OPS), json.dumps(HOST_OPS),
         str(tmp_path / "xspace")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref_rows, ref_total = json.loads(proc.stdout.strip().splitlines()[-1])
    _chrome_trace(tmp_path / "chrome" / f"host.1.2{profiling.TRACE_SUFFIX}")
    rows, total, _ = xplane.device_op_table(str(tmp_path / "chrome"))
    assert rows == ref_rows
    assert total == ref_total == sum(p for _, p, _, _ in OPS) / 1e12
    assert [r["count"] for r in rows] == [2, 2, 2, 1]
    xplane.main([str(tmp_path / "chrome"), "--iters", "2", "--top", "3"])
    table = capsys.readouterr().out.splitlines()
    assert table[1] == f"# device total: {1e3 * total / 2:.2f} ms/iter over 4 kernels"
    assert len(table) == 3 + 3 and "ds_conv3x3_pw_kernel" in table[3]
    xplane.main([str(tmp_path / "chrome"), "--iters", "2", "--roofline"])
    roof = capsys.readouterr().out
    assert "(no cost figures in the trace)" in roof and "composable bound" in roof
    sgemm = next(line for line in roof.splitlines() if "sgemm" in line)
    assert sgemm.split()[6] == "hbm"  # 6 MB at 3.35 TB/s outlasts 80 MFLOP at 989 TFLOP/s
