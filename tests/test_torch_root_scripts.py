"""The port's root scripts (``fastscnn_tpu_torch/tools/check_dw_impls.py``,
``ab_int8_pw.py``, ``ab_report.py``, ``ab_stem.sh``, ``sweep_ce19.sh``,
``sweep_bdd.sh`` and ``fastscnn_tpu_torch/examples/car_control_example.py``)
against the repo root's, on the CPU.

- ``check_dw_impls``: on JAX's ``init_fast_scnn(PRNGKey(0), 19)`` weights
  with BN statistics taken from one training-mode pass over the JAX tool's
  64×128 batch of 2 (default statistics give a one-class mask, on which
  any impl that keeps the class agrees), carried over by
  ``from_jax_params``, the conv mask has at least 3 classes and none on
  0.9 of its pixels. In f32 each impl's mask agrees with the JAX engine's
  for the same impl on at least 0.995 of pixels (PARITY.md's gate). In
  bf16, the tool's dtype, these random weights leave most pixels on
  near-ties (the JAX engine's own bf16 mask matches its f32 mask on about
  half of them), so each impl's bf16 mask must agree with the JAX tool's
  at least as well as the JAX tool's agrees with JAX's f32 mask. Fed
  JAX's masks, the port's report prints the JAX tool's lines character
  for character.
- ``ab_int8_pw``: the sites are the JAX module's; the site inputs drawn
  from ``default_rng(0)`` equal the JAX tool's own draws bit for bit at
  every site; each variant at each site cut to 96 rows against the JAX
  function on the same inputs: B8 bit for bit; B7 to bf16 within one
  bf16 ulp (2^-7 of the larger value) plus ``pw_conv_a8_tolerance``, to
  int8 within one level; the bf16 baseline within one bf16 ulp plus its
  bias's rounding to bf16 (the port's ``addmm`` takes a bf16 bias, the
  JAX baseline an f32 one).
- The shell scripts: the JAX script and the port's, each run under a
  recording ``python`` put first on ``PATH``, make the same invocations in
  the same order with the same knobs and timeouts, once the JAX script
  paths are mapped to the port's modules. The JAX ``sweep_bdd.sh`` sends
  its benches' stderr to a fixed file under ``/tmp``; it runs as a copy
  whose only change is that file replaced by ``$ERR``.
- ``ab_report``: the same summary as the JAX module's on one log, and on
  that log with ``fps/chip`` renamed to ``fps/card`` the same but for the
  unit's name.
- ``car_control_example``: on a fake clock, the same printed lines (the
  wheels after every command) as the JAX example's, ending stopped.
"""

import contextlib
import hashlib
import importlib.util
import inspect
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastscnn_tpu.models as jax_models
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.ops.conv import BN_MOMENTUM
from fastscnn_tpu.ops.pallas import int8_pw as jax_int8
from fastscnn_tpu_torch.examples import car_control_example
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params
from fastscnn_tpu_torch.ops.cuda import launch_counts, pw_conv_a8_tolerance
from fastscnn_tpu_torch.tools import ab_int8_pw, ab_report, check_dw_impls

REPO = Path(__file__).resolve().parent.parent
MASK_GATE = 0.995  # PARITY.md's gate for bf16 masks
ULP_BF16 = 2.0**-7  # one bf16 ulp relative to the larger of the two values
CUT_M = 96  # rows of each int8 site held against JAX


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# -- check_dw_impls --------------------------------------------------------------
DW_SHAPE = (2, 64, 128, 3)  # the JAX tool's batch, cut to 64×128 and 2 frames


@pytest.fixture(scope="module")
def jax_dw_weights():
    """JAX's ``init_fast_scnn(PRNGKey(0), 19)`` with BN running statistics
    from one training-mode pass over the tool's batch, raw in [0, 1] as the
    engine's default config feeds it: the momentum update inverted, so the
    statistics are the batch's."""
    params, state = jax_init(jax.random.PRNGKey(0), 19)
    x = np.random.default_rng(0).integers(0, 256, DW_SHAPE, dtype=np.uint8)
    _, new = JaxFastSCNN(num_classes=19).apply(params, state, jnp.asarray(x / 255.0, jnp.float32),
                                               training=True)
    state = jax.tree_util.tree_map(
        lambda o, n: np.asarray(o) + (np.asarray(n) - np.asarray(o)) / BN_MOMENTUM, state, new)
    return jax.tree_util.tree_map(np.asarray, params), state


@pytest.fixture(scope="module")
def jax_dw_f32_masks(jax_dw_weights):
    """Each impl's mask from the JAX engine in f32 on the same weights and
    batch."""
    from fastscnn_tpu.engine import E2EConfig, InferenceEngine

    x = np.random.default_rng(0).integers(0, 256, DW_SHAPE, dtype=np.uint8)
    return {impl: np.asarray(InferenceEngine(JaxFastSCNN(num_classes=19, folded_dw_impl=impl),
                                             *jax_dw_weights,
                                             config=E2EConfig(compute_dtype="float32")).predict(x))
            for impl in check_dw_impls.DW_IMPLS}


@pytest.fixture(scope="module")
def jax_dw_run(jax_dw_weights):
    """The JAX tool's ``main`` at 64×128, batch 2, on
    :func:`jax_dw_weights`: its stdout and each impl's mask (recorded from
    its engines' ``predict``)."""
    import fastscnn_tpu.engine as jax_engine

    tool = _load("tools/check_dw_impls.py", "jax_check_dw_impls")
    masks = []

    class Recording(jax_engine.InferenceEngine):
        def predict(self, x):
            out = super().predict(x)
            masks.append(np.asarray(out))
            return out

    argv, real, init = sys.argv, jax_engine.InferenceEngine, jax_models.init_fast_scnn
    sys.argv = ["check_dw_impls.py", "--height", "64", "--width", "128", "--batch", "2"]
    jax_engine.InferenceEngine = Recording
    jax_models.init_fast_scnn = lambda key, classes: jax_dw_weights
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            tool.main()
    finally:
        sys.argv, jax_engine.InferenceEngine, jax_models.init_fast_scnn = argv, real, init
    return out.getvalue(), dict(zip(check_dw_impls.DW_IMPLS, masks))


def _agree(a, b):
    assert a.shape == b.shape == DW_SHAPE[:3]
    return float((a == b).mean())


def test_check_dw_impls_masks_match_jax_per_impl(jax_dw_weights, jax_dw_run, jax_dw_f32_masks):
    text, jax_masks = jax_dw_run
    model = FastSCNN(19)
    model.load_state_dict(from_jax_params(*jax_dw_weights))
    x = np.random.default_rng(0).integers(0, 256, DW_SHAPE, dtype=np.uint8)
    before = launch_counts()
    masks = check_dw_impls.impl_masks(model, x, "cpu")
    masks32 = check_dw_impls.impl_masks(model, x, "cpu", compute_dtype="float32")
    assert launch_counts() == before  # the CPU runs the plain versions
    assert list(masks) == list(masks32) == list(jax_masks) == list(check_dw_impls.DW_IMPLS)
    for conv in (masks["conv"], jax_masks["conv"], jax_dw_f32_masks["conv"]):
        assert np.bincount(conv.ravel()).max() < 0.9 * conv.size  # it carries information
        assert len(np.unique(conv)) >= 3
    for impl in check_dw_impls.DW_IMPLS:
        assert _agree(masks32[impl], jax_dw_f32_masks[impl]) >= MASK_GATE, impl
        # bf16: no further from the JAX tool than bf16 moves the JAX tool itself
        spread = _agree(jax_masks[impl], jax_dw_f32_masks[impl])
        assert _agree(masks[impl], jax_masks[impl]) >= spread, impl
    # the JAX tool's lines, character for character, from its own masks
    assert text.splitlines() == check_dw_impls.report(jax_masks) + ["done"]
    for line in check_dw_impls.report(masks):
        assert re.fullmatch(r"[a-z-]+ +vs conv: pixel diff \d\.\d{3}e[+-]\d\d  \[(OK|SUSPECT)\]",
                            line), line


def test_check_dw_impls_main_prints_each_impl_then_done(capsys):
    masks = check_dw_impls.main(["--height", "64", "--width", "128", "--batch", "1",
                                 "--classes", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == list(check_dw_impls.DW_IMPLS[1:]) + ["done"]
    assert all(m.shape == (1, 64, 128) for m in masks.values())


@pytest.mark.parametrize("tool,argv", [
    (check_dw_impls, ["--height", "64", "--width", "128", "--batch", "1"]),
    (ab_int8_pw, ["--batch", "1", "--sites", "ds2-pw"]),
])
def test_tools_raise_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


# -- ab_int8_pw --------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_pw_run():
    """The JAX tool's ``main`` at batch 1 with its timing loop replaced by
    a recorder: per site, each variant's function and input (whose
    closures hold the site's operands), and the JSON it printed."""
    tool = _load("tools/ab_int8_pw.py", "jax_ab_int8_pw")
    seen = []

    def record(fn, x0, iters, repeat):
        seen.append((fn, x0))
        return 1e-3

    tool._time_loop = record
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool.main(["--batch", "1", "--iters", "1", "--repeat", "1"])
    line = json.loads(out.getvalue().splitlines()[-1])
    names = ("bf16-xla", "a8-bf16out", "a8-i8out", "w8a8-i8out")
    sites = {}
    for i, (name, *_) in enumerate(tool.SITES):
        variants = dict(zip(names, seen[4 * i:4 * i + 4]))
        ops = {}
        for fn, _ in variants.values():
            ops.update(inspect.getclosurevars(fn).nonlocals)
        sites[name] = {"ops": ops, "bf16_ref": variants["bf16-xla"][0],
                       "x_bf": variants["bf16-xla"][1], "x_q": variants["a8-bf16out"][1]}
    return tool, sites, line


def test_ab_int8_pw_sites_and_inputs_equal_the_jax_tools(jax_pw_run):
    tool, sites, _ = jax_pw_run
    assert ab_int8_pw.SITES == tool.SITES
    rng = np.random.default_rng(0)
    for name, h, w, k, n in ab_int8_pw.SITES:
        inp = ab_int8_pw.site_inputs(h * w, k, n, rng, "cpu")
        ref = sites[name]
        pairs = {"x_bf": ref["x_bf"], "x_q": ref["x_q"], "w_bf": ref["ops"]["w_bf"],
                 "b": ref["ops"]["bj"], "w_q": ref["ops"]["w_q"], "cs": ref["ops"]["cs"]}
        for key, want in pairs.items():
            got = inp[key]
            assert got.shape == tuple(want.shape), (name, key)
            if got.dtype == torch.bfloat16:  # compare the bits
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              np.asarray(want).view(np.int16), err_msg=name)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def _cut(inp):
    return {key: (v[:CUT_M] if key.startswith("x") else v) for key, v in inp.items()}


@pytest.mark.parametrize("site", [s[0] for s in ab_int8_pw.SITES])
def test_ab_int8_pw_variants_match_the_jax_functions(jax_pw_run, site):
    """Each variant on the site's first 96 rows against the JAX function
    on the same operands: its XLA path, and at ``ds2-pw`` also its Pallas
    kernel in the interpreter."""
    _, sites, _ = jax_pw_run
    name, h, w, k, n = next(s for s in ab_int8_pw.SITES if s[0] == site)
    ref = sites[site]
    ops = ref["ops"]
    rng = np.random.default_rng(0)
    for s in ab_int8_pw.SITES:  # replay the draws up to this site's
        inp = ab_int8_pw.site_inputs(s[1] * s[2], s[3], s[4], rng, "cpu")
        if s[0] == site:
            break
    inp = _cut(inp)
    got = {v: fn(x0) for v, (fn, x0, *_) in
           ab_int8_pw.variants(inp, ab_int8_pw.site_tiles(h * w, k, n)).items()}
    x_bf, x_q = ref["x_bf"][:CUT_M], ref["x_q"][:CUT_M]
    interprets = (False, True) if site == "ds2-pw" else (False,)
    for interpret in interprets:
        kw = dict(use_pallas=interpret, interpret=interpret)
        want = {
            "bf16-xla": ref["bf16_ref"](x_bf),  # the JAX tool's own baseline
            "a8-bf16out": jax_int8.pw_conv_a8(x_q, ops["w_bf"], ops["bj"], **kw),
            "a8-i8out": jax_int8.pw_conv_a8(x_q, ops["w_bf"], ops["bj"], quantize_out=True,
                                            **kw),
            "w8a8-i8out": jax_int8.pw_conv_w8a8(x_q, ops["w_q"], ops["cs"], ops["bj"],
                                                quantize_out=True, **kw),
        }
        for v in want:
            g, r = _np(got[v]), _np(want[v])
            assert g.shape == r.shape == (CUT_M, n), v
        np.testing.assert_array_equal(_np(got["w8a8-i8out"]), _np(want["w8a8-i8out"]))
        assert np.abs(_np(got["a8-i8out"]) - _np(want["a8-i8out"])).max() <= 1.0
        g, r = _np(got["a8-bf16out"]), _np(want["a8-bf16out"])
        allow = (ULP_BF16 * np.maximum(np.abs(g), np.abs(r))
                 + pw_conv_a8_tolerance(inp["x_q"], inp["w_bf"]).numpy())
        assert np.all(np.abs(g - r) <= allow), (site, np.max(np.abs(g - r) - allow))
        g, r = _np(got["bf16-xla"]), _np(want["bf16-xla"])
        b = inp["b"].numpy()
        b_round = np.abs(b - inp["b"].to(torch.bfloat16).float().numpy())
        allow = ULP_BF16 * np.maximum(np.abs(g), np.abs(r)) + b_round[None, :]
        assert np.all(np.abs(g - r) <= allow), (site, np.max(np.abs(g - r) - allow))


def test_ab_int8_pw_main_gives_the_jax_tools_keys(jax_pw_run, capsys):
    _, _, jax_line = jax_pw_run
    out = ab_int8_pw.main(["--batch", "1", "--iters", "2", "--repeat", "1", "--sites", "ds2-pw",
                           "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert set(out) == set(jax_line)
    site, ref = out["sites"]["ds2-pw"], jax_line["sites"]["ds2-pw"]
    assert list(out["sites"]) == ["ds2-pw"]
    assert {key: site[key] for key in ("m", "k", "n")} == {key: ref[key] for key in ("m", "k", "n")}
    assert list(site["rows"]) == list(ref["rows"])
    for v, row in site["rows"].items():
        # besides: the tile that ran, the loop's own µs and the GB/s net of it
        assert set(row) == set(ref["rows"][v]) | {"tile", "loop_us", "net_GB/s"}
        assert row["us"] > row["loop_us"] > 0 and row["net_GB/s"] > row["GB/s"] > 0
    assert site["rows"]["bf16-xla"]["tile"] == "library"
    assert site["rows"]["w8a8-i8out"]["tile"] == "128x64"  # B8's streaming tile at K, N <= 64


def test_ab_int8_pw_block_m_forces_a_tile_or_raises():
    from fastscnn_tpu_torch.ops.cuda.int8_pw import pw_a8_plan, pw_w8a8_plan

    m, k, n = 32768, 48, 64  # ds2-pw at batch 1: B8 streams (tile 3, 128 x 64)
    assert ab_int8_pw.site_tiles(m, k, n) == (pw_a8_plan(m, k, n).tile,
                                              pw_w8a8_plan(m, k, n).tile)
    assert ab_int8_pw.site_tiles(m, k, n, 128) == (0, 3)  # B8 keeps its plan's 128-row tile
    assert ab_int8_pw.site_tiles(m, k, n, 64) == (1, 1)
    assert ab_int8_pw.site_tiles(2048, 96, 576, 128) == (0, 0)  # B8's plan takes 64 x 64 there
    assert ab_int8_pw.site_tiles(2048, 96, 576, 32) == (2, 2)
    with pytest.raises(ValueError, match=r"no block tile has BM 96; .*128x128, 64x64, 32x64"):
        ab_int8_pw.main(["--block-m", "96", "--device", "cpu"])


# -- the shell scripts --------------------------------------------------------------
SHIM = """#!{python}
import json, os, sys
parent = open(f"/proc/{{os.getppid()}}/cmdline", "rb").read().split(b"\\0")
timeout = parent[1].decode() if os.path.basename(parent[0].decode()) == "timeout" else None
rec = {{"argv": sys.argv[1:], "cwd": os.getcwd(), "timeout": timeout,
       "env": {{k: v for k, v in sorted(os.environ.items()) if k.startswith("BENCH_")}}}}
with open(os.environ["SHIM_LOG"], "a") as f:
    f.write(json.dumps(rec) + "\\n")
"""

# the JAX scripts' python files and their modules in the port
MODULES = {"tools/check_dw_impls.py": "fastscnn_tpu_torch.tools.check_dw_impls",
           "bench.py": "fastscnn_tpu_torch.bench",
           "bench_train.py": "fastscnn_tpu_torch.bench_train",
           "tools/ab_report.py": "fastscnn_tpu_torch.tools.ab_report"}
# the log each ab_stem.sh summarizes last: the JAX watcher's, the port's
LOGS = {"/tmp/ab_stem_results.log": "<log>", "build/ab_stem_results.log": "<log>"}


def _jax_script(name, tmp_path):
    """The JAX script to run. ``sweep_bdd.sh`` sends its benches' stderr
    to ``/tmp/sweep_bdd_err.log``, outside the checkout: it runs as a copy
    (under ``tmp_path/jax/tools``, so it ``cd``s to ``tmp_path/jax``) whose
    only change is that path replaced by ``"$ERR"``."""
    src = REPO / "tools" / name
    if name != "sweep_bdd.sh":
        return src
    text, fixed = src.read_text(), "/tmp/sweep_bdd_err.log"
    assert text.count(fixed) == 1 and '"$ERR"' not in text
    copy = tmp_path / "jax" / "tools" / name
    copy.parent.mkdir(parents=True)
    copy.write_text(text.replace(fixed, '"$ERR"'))
    assert copy.read_text().replace('"$ERR"', fixed) == text  # the only change
    return copy


def _run_script(script, tmp_path, tag):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(SHIM.format(python=sys.executable))
    shim.chmod(0o755)
    log = tmp_path / f"{tag}.jsonl"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k not in ("PYTHON", "OUT", "ERR", "ITERS",
                                                       "AB_LOG")}
    env.update(PATH=f"{bin_dir}{os.pathsep}{env['PATH']}", SHIM_LOG=str(log),
               OUT=str(tmp_path / f"{tag}_out.jsonl"), ERR=str(tmp_path / f"{tag}_err.log"))
    proc = subprocess.run(["bash", str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    out = tmp_path / f"{tag}_out.jsonl"
    return calls, proc.stdout, out.read_text() if out.exists() else None


def _as_port(call):
    """The call's argv in the port's terms, its knobs and timeout (not its
    working directory, which each test checks)."""
    argv = call["argv"]
    if argv[0] in MODULES:
        argv = ["-m", MODULES[argv[0]]] + argv[1:]
    return {**{k: v for k, v in call.items() if k != "cwd"},
            "argv": [LOGS.get(a, a) for a in argv]}


def _docs_digest():
    h = hashlib.sha256()
    for p in sorted((REPO / "docs").rglob("*")):
        if p.is_file():
            h.update(str(p.relative_to(REPO)).encode() + p.read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["ab_stem.sh", "sweep_ce19.sh", "sweep_bdd.sh"])
def test_shell_scripts_make_the_jax_scripts_invocations(tmp_path, name):
    docs = _docs_digest()
    jax_script = _jax_script(name, tmp_path)
    jax_calls, jax_out, jax_file = _run_script(jax_script, tmp_path, "jax")
    port_calls, port_out, port_file = _run_script(REPO / "fastscnn_tpu_torch" / "tools" / name,
                                                  tmp_path, "port")
    assert _docs_digest() == docs  # the JAX sweep_bdd.sh wrote to OUT, not docs/
    assert len(jax_calls) >= 3
    assert [_as_port(c) for c in jax_calls] == [_as_port(c) for c in port_calls]
    assert {c["cwd"] for c in jax_calls} == {str(jax_script.parent.parent)}  # its root
    for call in port_calls:
        assert call["argv"][:2] == ["-m", call["argv"][1]]
        assert call["argv"][1].startswith("fastscnn_tpu_torch.")
        assert call["cwd"] == str(REPO)
    assert port_out == jax_out
    assert port_file == jax_file  # sweep_bdd's "### <knobs>" lines (None for the others)


def test_port_sweep_bdd_writes_under_build_by_default():
    text = (REPO / "fastscnn_tpu_torch/tools/sweep_bdd.sh").read_text()
    assert "OUT=${OUT:-build/" in text and "ERR=${ERR:-build/" in text
    assert "docs/" not in text and "/tmp" not in text


# -- ab_report ---------------------------------------------------------------------
def _ab_log():
    rng = np.random.default_rng(3)
    lines = ["== device mask parity ==", "taps         vs conv: pixel diff 0.000e+00  [OK]"]
    for rep in (1, 2):
        for impl in ("conv", "taps", "pallas", "fused-ds", "fused-ds-mr"):
            lines += [f"--- rep {rep} dw_impl={impl}", "batch 128: 900.0 fps",
                      json.dumps({"metric": "m", "value": float(rng.uniform(800, 1200)),
                                  "unit": "fps/chip", "batch": 128})]
    lines.append('{"metric": broken json')
    lines.append(json.dumps({"no_metric": 1}))
    for rep in (1, 2):
        for impl in ("xla", "tapbwd", "taps", "taps-packbn", "pallas"):
            lines += [f"--- rep {rep} stem_impl={impl}",
                      json.dumps({"metric": "t", "value": float(rng.uniform(200, 400)),
                                  "unit": "samples/sec/chip"})]
    lines.append("--- rep 3 stem_impl=xla")  # a rep without the baseline's partner
    lines.append(json.dumps({"metric": "t", "value": 250.0, "unit": "samples/sec/chip"}))
    return "\n".join(lines) + "\n"


def test_ab_report_prints_the_jax_summary(tmp_path, capsys):
    tool = _load("tools/ab_report.py", "jax_ab_report")
    path = tmp_path / "ab.log"
    path.write_text(_ab_log())
    argv = sys.argv
    sys.argv = ["ab_report.py", str(path)]
    try:
        tool.main()
    finally:
        sys.argv = argv
    want = capsys.readouterr().out
    ab_report.main([str(path)])
    assert capsys.readouterr().out == want
    assert "vs conv" in want and "rep 2 vs xla" in want
    card = tmp_path / "card.log"
    card.write_text(_ab_log().replace("fps/chip", "fps/card"))
    ab_report.main([str(card)])
    assert capsys.readouterr().out == want.replace("fps/chip", "fps/card")
    empty = tmp_path / "empty.log"
    empty.write_text("nothing\n")
    ab_report.main([str(empty)])
    assert capsys.readouterr().out == f"no bench JSON lines found in {empty}\n"


# -- car_control_example -----------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_car_control_example_matches_jax(monkeypatch, capsys):
    tool = _load("examples/car_control_example.py", "jax_car_control_example")
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock.time)
    monkeypatch.setattr(time, "sleep", clock.sleep)
    monkeypatch.setattr(sys, "argv", ["car_control_example.py"])
    tool.main()
    want = capsys.readouterr().out
    clock.t = 1000.0
    transport = car_control_example.main([])
    got = capsys.readouterr().out
    assert got == want
    wheels = re.findall(r"wheels now \((-?\d+), (-?\d+)\)", got)
    assert len(wheels) == 13 and wheels[0] == ("500", "500") and wheels[-1] == ("0", "0")
    assert transport.vehicle.wheels == (0, 0)
