"""The car's side of the port — the register-level MCU firmware
(``serialbridge/mcu.py`` over its own ``mcu.cpp``), the rich framed
protocol, manual control and the analyzers — against the JAX package's
modules, on the CPU.

Both firmware libraries are built with g++ (the JAX one into its own
package directory, the port's into ``build/fastscnn_tpu_torch/``) and
driven by the same seeded call sequences and byte streams; every register,
the tx bytes, the watchdog stops and the error counters must be equal
after every call. The protocol and tool tests compare bytes, frames,
simulator state, commands and dicts exactly.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from fastscnn_tpu.serialbridge import SimpleCarController as JaxCar
from fastscnn_tpu.serialbridge import mcu as jmcu
from fastscnn_tpu.serialbridge import rich_protocol as jrich
from fastscnn_tpu.tools import analyzers as janalyzers
from fastscnn_tpu.tools import manual_control as jmanual
from fastscnn_tpu_torch import serialbridge as P
from fastscnn_tpu_torch.serialbridge import mcu as pmcu
from fastscnn_tpu_torch.serialbridge import rich_protocol as prich
from fastscnn_tpu_torch.tools import analyzers as panalyzers
from fastscnn_tpu_torch.tools import manual_control as pmanual

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the MCU firmware ------------------------------------------------------------------


def _registers(m):
    """Every register and counter the bindings expose, and the tx bytes."""
    return (m.gpioa_odr, m.tim3_arr, m.tim3_psc, [m.tim3_ccr(c) for c in (1, 2, 3, 4)],
            m.tim3_enabled, m.rcc_apb2enr, m.rcc_apb1enr, m.usart_brr, m.rx_len,
            m.motor_enabled, m.wheel_velocities, m.speeds, m.watchdog_stops,
            m.checksum_errors, m.protocol_errors, m.read_tx())


def _framed_noise(rng):
    """One poll's bytes: packets, some corrupted in the checksum, header or
    tail, with noise bytes between some of them."""
    out = bytearray()
    for _ in range(int(rng.integers(0, 4))):
        pkt = bytearray(P.pack_packet(int(rng.integers(-1300, 1300)),
                                      int(rng.integers(-1300, 1300))))
        kind = rng.random()
        if kind < 0.15:
            pkt[5] ^= int(rng.integers(1, 256))
        elif kind < 0.25:
            pkt[int(rng.choice([0, 6]))] ^= 0x0F
        if rng.random() < 0.2:
            out += bytes(rng.integers(0, 256, int(rng.integers(1, 4)), dtype=np.uint8))
        out += pkt
    return bytes(out)


def _mcu_calls(rng, n):
    """A seeded sequence of (method, args) over the whole Mcu surface."""
    calls, now = [], 0
    for _ in range(n):
        k = int(rng.integers(0, 12))
        if k == 0:
            calls.append(("motor_gpio_init", ()))
        elif k == 1:
            calls.append(("motor_pwm_init", ()))
        elif k == 2:
            calls.append(("motor_set_speed", (int(rng.integers(0, 1600)),)))
        elif k == 3:
            calls.append(("motor_enable", (bool(rng.integers(0, 2)),)))
        elif k == 4:
            calls.append(("motor_set_direction", (str(rng.choice(list(pmcu.DIRECTIONS))),)))
        elif k == 5:
            calls.append(("motor_set_direction_with_speed",
                          (str(rng.choice(list(pmcu.DIRECTIONS))), int(rng.integers(0, 1600)))))
        elif k == 6:
            calls.append(("motor_set_differential",
                          (int(rng.integers(0, 1600)), int(rng.integers(0, 1600)))))
        elif k == 7:
            calls.append(("usart_irq_rx", (int(rng.integers(0, 256)),)))
        elif k == 8:
            calls.append(("rs232_send", (bytes(rng.integers(32, 127, 6, dtype=np.uint8)),)))
        elif k == 9:
            calls.append(("set_wheel_speeds",
                          (int(rng.integers(-1300, 1300)), int(rng.integers(-1300, 1300)))))
        else:
            now += int(rng.integers(0, 700))
            calls.append(("poll", (_framed_noise(rng), now)))
    return calls


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ring, drop_ff", [(0, False), (5, True), (0, True)])
def test_mcu_equals_jax_on_seeded_call_sequences(seed, ring, drop_ff):
    """The port's ``Mcu`` and JAX's, booted (or not) alike, take the same
    120 calls: each return value and every register after each call equal."""
    rng = np.random.default_rng(seed)
    port, ref = pmcu.Mcu(rx_ring_len=ring), jmcu.Mcu(rx_ring_len=ring)
    for m in (port, ref):
        if seed % 2:
            m.boot()
        m.usart_init(9600 + 100 * seed)
        m.usart_set_drop_ff(drop_ff)
    assert _registers(port) == _registers(ref)
    for name, args in _mcu_calls(rng, 120):
        assert getattr(port, name)(*args) == getattr(ref, name)(*args), (name, args)
        assert _registers(port) == _registers(ref), (name, args)


def test_the_firmware_builds_under_build_and_not_at_import():
    code = ("import fastscnn_tpu_torch.serialbridge.mcu as m\n"
            "assert m._LIB is None\n"
            "print(m.load_mcu()._name)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "fastscnn_tpu_torch")
    assert os.path.basename(path).startswith("libmcufirmware-") and path.endswith(".so")
    with open(os.path.join(REPO, "fastscnn_tpu_torch", "serialbridge", "mcu.cpp"), "rb") as a, \
            open(os.path.join(REPO, "fastscnn_tpu", "serialbridge", "mcu.cpp"), "rb") as b:
        assert a.read() == b.read()  # the port's copy of the firmware is verbatim


@pytest.mark.parametrize("seed", range(4))
def test_register_vehicle_equals_the_ports_vehicle_sim_on_framed_streams(seed):
    """The JAX ``test_register_vehicle_matches_vehiclesim_on_framed_streams``
    on the port's pair: well-framed packets (the shared contract) with
    silent gaps that trip the watchdog, wheels equal after each feed and
    tick, and the same watchdog stops; and the port's RegisterVehicle equal
    to JAX's on the same trace."""
    rng = np.random.default_rng(seed)
    reg, sim, jreg = pmcu.RegisterVehicle(), P.VehicleSim(timeout_ms=500), jmcu.RegisterVehicle()
    now = 0
    for _ in range(50):
        data = P.pack_packet(int(rng.integers(-1200, 1200)), int(rng.integers(-1200, 1200)))
        now += int(rng.integers(1, 400))
        assert reg.feed(data, now) == jreg.feed(data, now)
        sim.feed(data, now)
        assert reg.wheels == sim.wheels == jreg.wheels
        if rng.random() < 0.2:
            now += 600
            assert reg.tick(now) == jreg.tick(now)
            sim.tick(now)
            assert reg.wheels == sim.wheels == jreg.wheels == (0, 0)
    assert reg.watchdog_stops == sim.watchdog_stops == jreg.watchdog_stops > 0
    assert reg.checksum_errors == jreg.checksum_errors == 0


def test_register_vehicle_keeps_the_fixed_watchdog():
    for timeout in (100, 499, 501, 1000):
        with pytest.raises(ValueError, match="fixed at 500 ms"):
            pmcu.RegisterVehicle(timeout_ms=timeout)
    assert pmcu.WHEELS == jmcu.WHEELS and pmcu.DIRECTIONS == jmcu.DIRECTIONS


# -- the rich framed protocol ----------------------------------------------------------


@pytest.mark.parametrize("cmd", [0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0xAA, 0x55])
def test_frame_command_bytes_equal_jax(cmd):
    rng = np.random.default_rng(cmd)
    for n in (0, 1, 2, 6, 8, 31, 32, 40):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert prich.frame_command(cmd, data) == jrich.frame_command(cmd, data)


def _noisy_stream(rng):
    """Frames with noise, false headers (0xAA then a long or a short
    length), broken checksums and tails between them."""
    out = bytearray()
    for _ in range(int(rng.integers(5, 25))):
        kind = rng.random()
        if kind < 0.5:
            payload = bytes(rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8))
            frame = bytearray(prich.frame_command(int(rng.integers(1, 7)), payload))
            if rng.random() < 0.15:
                frame[-2] ^= 0x33
            if rng.random() < 0.1:
                frame[-1] = 0x00
            out += frame
        elif kind < 0.7:
            out += bytes([0xAA, int(rng.integers(0, 256)), int(rng.integers(0, 256))])
        else:
            out += bytes(rng.integers(0, 256, int(rng.integers(1, 6)), dtype=np.uint8))
    return bytes(out)


@pytest.mark.parametrize("seed", range(6))
def test_parse_frames_equals_jax_on_noisy_split_buffers(seed):
    """The same noisy stream fed to each parser in the same random pieces:
    the frames of every call and the bytes left in the buffer equal."""
    rng = np.random.default_rng(seed)
    stream = _noisy_stream(rng)
    cuts = sorted(set(int(c) for c in rng.integers(0, len(stream), 8))) + [len(stream)]
    pbuf, jbuf, start, frames = bytearray(), bytearray(), 0, 0
    for cut in cuts:
        pbuf += stream[start:cut]
        jbuf += stream[start:cut]
        start = cut
        got = prich.parse_frames(pbuf)
        assert got == jrich.parse_frames(jbuf)
        assert pbuf == jbuf
        frames += len(got)
    assert frames > 0


def test_steering_ratios_equal_jax():
    for s in np.linspace(-1.5, 1.5, 61):
        assert prich._steering_ratios(float(s)) == jrich._steering_ratios(float(s))


class _SimTransport:
    def __init__(self, sim):
        self.sim = sim
        self.written = bytearray()

    def write(self, data):
        self.written += data
        self.sim.feed(data)

    def read(self, maxlen=16, timeout_ms=100):
        out = bytes(self.sim.responses[:maxlen])
        del self.sim.responses[: len(out)]
        return out


def _car_state(car, sim, transport):
    return (car.current_speed, car.current_steering, car.current_mode, car.is_connected,
            list(sim.wheels), sim.stopped, bytes(transport.written))


@pytest.mark.parametrize("seed", range(4))
def test_car_controller_and_rich_sim_equal_jax(seed):
    """The same seeded command sequence through the port's
    ``CarController`` → ``RichVehicleSim`` and JAX's: the bytes on the
    wire, the controller's state, the four wheel PWMs and the status
    replies equal after every command; the context manager stops and
    disconnects alike."""
    rng = np.random.default_rng(seed)
    psim, jsim = prich.RichVehicleSim(), jrich.RichVehicleSim()
    pt, jt = _SimTransport(psim), _SimTransport(jsim)
    with prich.CarController(transport=pt) as pcar, jrich.CarController(transport=jt) as jcar:
        assert _car_state(pcar, psim, pt) == _car_state(jcar, jsim, jt)
        for _ in range(40):
            k = int(rng.integers(0, 5))
            speed, steer = float(rng.uniform(-0.2, 1.2)), float(rng.uniform(-1.3, 1.3))
            if k == 0:
                got, ref = pcar.set_speed(speed), jcar.set_speed(speed)
            elif k == 1:
                got, ref = pcar.set_steering(steer), jcar.set_steering(steer)
            elif k == 2:
                got, ref = pcar.set_motion(speed, steer), jcar.set_motion(speed, steer)
            elif k == 3:
                got, ref = pcar.emergency_stop(), jcar.emergency_stop()
            else:
                got, ref = pcar.get_status(), jcar.get_status()
            assert got == ref
            assert _car_state(pcar, psim, pt) == _car_state(jcar, jsim, jt)
    assert _car_state(pcar, psim, pt) == _car_state(jcar, jsim, jt)
    assert psim.stopped and not pcar.is_connected
    assert not prich.CarController().set_speed(0.5)  # no transport: nothing sent


# -- manual control --------------------------------------------------------------------


class _Sent:
    def __init__(self):
        self.sent = []

    def send_speeds(self, left, right):
        self.sent.append((left, right))


@pytest.mark.parametrize("key", list("wsadqe xz?WA") + ["\x03", "\x04"])
def test_teleop_step_gives_the_jax_tools_commands(key):
    pt, jt = _Sent(), _Sent()
    pcar, jcar = P.SimpleCarController(transport=pt), JaxCar(transport=jt)
    for car in (pcar, jcar):
        car.set_wheel_speeds(123, -45)
    assert pmanual.teleop_step(pcar, key) == jmanual.teleop_step(jcar, key)
    assert pt.sent == jt.sent and pcar.get_current_speeds() == jcar.get_current_speeds()


def _post(base, path, payload):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_web_car_server_requests_give_the_jax_tools_commands():
    """The same requests to the port's ``WebCarServer`` and JAX's: equal
    status codes, JSON replies and commands sent; the page and /api/state."""
    requests = [("/api/forward", {"speed": 0.3}), ("/api/wheels", {"left": 150, "right": -150}),
                ("/api/turn_left", {"speed": 0.6, "intensity": 0.25}), ("/api/turn_right", {}),
                ("/api/backward", {"speed": 0.45}), ("/api/spin_left", {"speed": 0.2}),
                ("/api/spin_right", {}), ("/api/wheels", {"left": 5000}), ("/api/nothing", {}),
                ("/api/stop", {})]
    replies, sent, pages = [], [], []
    for car_cls, server_cls in ((P.SimpleCarController, pmanual.WebCarServer),
                                (JaxCar, jmanual.WebCarServer)):
        t = _Sent()
        server = server_cls(car_cls(transport=t), host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{server.start()}"
        try:
            replies.append([_post(base, path, body) for path, body in requests])
            with urllib.request.urlopen(f"{base}/api/state", timeout=10) as r:
                state = json.loads(r.read())
            with urllib.request.urlopen(f"{base}/", timeout=10) as r:
                pages.append(r.read())
            sent.append(t.sent)
        finally:
            server.stop()
    assert replies[0] == replies[1] and sent[0] == sent[1] and pages[0] == pages[1]
    assert replies[0][0] == (200, {"ok": True, "left": 300, "right": 300})
    assert replies[0][-2] == (404, {"error": "not found"})
    assert state["left_wheel_speed"] == state["right_wheel_speed"] == 0


def test_manual_control_main_refuses_a_missing_port(tmp_path):
    missing = str(tmp_path / "no-such-tty")
    for main in (pmanual.main, jmanual.main):
        with pytest.raises(SystemExit, match="cannot open"):
            main(["web", "--port", missing])


# -- the analyzers ---------------------------------------------------------------------


def _monitor_log(tmp_path, losses, with_val):
    """A JSON log written by the port's TrainingMonitor."""
    from fastscnn_tpu_torch.utils.monitor import TrainingMonitor

    path = str(tmp_path / "training_log.json")
    mon = TrainingMonitor(path)
    rng = np.random.default_rng(len(losses))
    for epoch, loss in enumerate(losses):
        val = dict(pix_acc=float(rng.uniform(0.5, 0.95)), miou=float(rng.uniform(0.2, 0.7))) \
            if with_val and epoch % 2 == 0 else {}
        mon.log_epoch(epoch, loss, 0.01 / (epoch + 1), samples_per_sec=100.0 + epoch, **val)
    if not losses:  # a run stopped before its first epoch: an empty log
        with open(path, "w") as f:
            json.dump([], f)
    return path


@pytest.mark.parametrize("losses, with_val", [
    ((1.0, 0.8, 0.7, 0.65), True),
    ((1.0, 0.9, 0.8, 0.8, 0.81, 0.82, 0.8), True),  # a plateau: the hint
    ((2.0, 1.0), False),
    ((), False),
])
def test_analyze_training_log_equals_jax(tmp_path, losses, with_val, capsys):
    path = _monitor_log(tmp_path, losses, with_val)
    got = panalyzers.analyze_training_log(path)
    assert got == janalyzers.analyze_training_log(path)
    if with_val:
        with open(path) as f:
            records = json.load(f)
        best = max((r for r in records if "miou" in r), key=lambda r: r["combined_metric"])
        assert got["best_epoch"] == best["epoch"]
    panalyzers.main(["training", "--log", path])
    janalyzers.main(["training", "--log", path])
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]


@pytest.mark.parametrize("seed", range(3))
def test_control_latency_analyzer_equals_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref = panalyzers.ControlLatencyAnalyzer(), janalyzers.ControlLatencyAnalyzer()
    assert port.stats() == ref.stats() == {"sends": 0}
    now = 1000.0
    for _ in range(int(rng.integers(2, 40))):
        lat = float(rng.uniform(0.0005, 0.02))
        now += float(rng.uniform(0.01, 0.9 if seed == 2 else 0.2))
        port.record_send(lat, now=now)
        ref.record_send(lat, now=now)
    assert port.stats() == ref.stats()
    assert port.report() == ref.report()
    assert ("WARNING" in port.report()) == (port.stats()["interval_mean_ms"] > 400)


class _StubStats(BaseHTTPRequestHandler):
    """/api/stats with a scripted fps sequence (0 first: a sample skipped)."""

    fps = [0.0, 9.5, 10.5, 7.0]
    calls = 0

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path != "/api/stats":
            self.send_response(404)
            self.end_headers()
            return
        cls = type(self)
        body = json.dumps({"fps": cls.fps[cls.calls % len(cls.fps)], "frame_count": cls.calls})
        cls.calls += 1
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def test_monitor_fps_against_a_stub_stats_server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _StubStats)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        result = panalyzers.monitor_fps(base, target_fps=8.0, duration_sec=0.45,
                                        poll_interval=0.05)
        assert result["samples"] >= 3 and result["target_fps"] == 8.0
        assert result["min_fps"] == 7.0 and 7.0 <= result["mean_fps"] <= 10.5
        assert result["slo_met"] == (result["mean_fps"] >= 8.0)
        none = panalyzers.monitor_fps("http://127.0.0.1:9", duration_sec=0.1, poll_interval=0.05)
        assert none == {"samples": 0, "slo_met": False}
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_monitor_fps_against_the_ports_dashboard():
    """The JAX ``test_monitor_fps_against_dashboard`` on the port's
    ``DashboardServer`` over a realtime loop."""
    from fastscnn_tpu_torch.interfaces import DashboardServer, RealtimePipeline, SyntheticCamera

    class RoadSession:
        def predict(self, rgb):
            mask = np.zeros(rgb.shape[:2], np.uint8)
            mask[rgb.shape[0] // 2:] = 1
            return mask

    pipeline = RealtimePipeline(RoadSession(), SyntheticCamera(), edge_computing=True)
    server = DashboardServer(pipeline, host="127.0.0.1", port=0)
    port = server.start()
    pipeline.start_background(max_frames=200)
    try:
        result = panalyzers.monitor_fps(f"http://127.0.0.1:{port}", target_fps=0.5,
                                        duration_sec=1.5, poll_interval=0.2)
        assert result["samples"] > 0 and result["mean_fps"] > 0
    finally:
        pipeline.stop()
        server.stop()


def test_protocol_constants_equal_jax():
    names = [n for n in dir(jrich) if n.isupper()]
    assert len(names) >= 12
    assert {n: getattr(prich, n) for n in names} == {n: getattr(jrich, n) for n in names}
