"""The port's serial bridge (``fastscnn_tpu_torch/serialbridge``, its own
``bridge.cpp``) against the JAX package's, on the CPU.

Both native libraries are built with g++ (the port's under
``build/fastscnn_tpu_torch/``) and fed the same bytes: packets over a grid
of speeds, clamping and corruption included; the streaming parser on
seeded fragmented and corrupted streams; the vehicle simulator's watchdog
on seeded command traces, step for step; the host controller's command
logic; and the controller → pty → ``VehicleSim`` loop.
"""

import os
import pty
import select
import subprocess
import sys

import numpy as np
import pytest

from fastscnn_tpu import serialbridge as J
from fastscnn_tpu_torch import serialbridge as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEEDS = (-32768, -5000, -1001, -1000, -999, -256, -255, -1, 0, 1, 127, 128, 255, 256, 999,
          1000, 1001, 5000, 32767)


def test_the_library_builds_under_build_and_not_at_import():
    code = ("import fastscnn_tpu_torch.serialbridge as sb\n"
            "assert sb._LIB is None\n"
            "lib = sb.load_bridge()\n"
            "print(lib._name)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "fastscnn_tpu_torch")
    assert os.path.basename(path).startswith("libserialbridge-") and path.endswith(".so")
    src = os.path.join(REPO, "fastscnn_tpu_torch", "serialbridge")
    assert sorted(f for f in os.listdir(src) if not f.startswith("__")) == ["bridge.cpp"]


@pytest.mark.parametrize("left", SPEEDS)
def test_pack_and_unpack_are_bit_equal(left):
    for right in SPEEDS:
        packet = P.pack_packet(left, right)
        assert packet == J.pack_packet(left, right)
        clamp = (max(-1000, min(1000, left)), max(-1000, min(1000, right)))
        assert P.unpack_packet(packet) == J.unpack_packet(packet) == clamp
        for i in range(7):  # every single-byte corruption
            bad = bytearray(packet)
            bad[i] ^= 0x5A
            assert P.unpack_packet(bytes(bad)) == J.unpack_packet(bytes(bad))


def _stream(rng, n_packets):
    """Packets with garbage between them, some with a broken checksum,
    header or tail."""
    out = bytearray()
    for _ in range(n_packets):
        out += bytes(rng.integers(0, 256, int(rng.integers(0, 4)), dtype=np.uint8))
        pkt = bytearray(J.pack_packet(*(int(v) for v in rng.integers(-1200, 1200, 2))))
        kind = rng.integers(0, 6)
        if kind == 0:
            pkt[5] ^= 0x01
        elif kind == 1:
            pkt[0] = 0x00
        elif kind == 2:
            pkt[6] = 0xAA
        out += pkt
    return bytes(out)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parser_on_fragmented_corrupted_streams_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    data = _stream(rng, 60)
    port, jax = P.Parser(), J.Parser()
    i = 0
    while i < len(data):
        n = int(rng.integers(1, 12))
        chunk = data[i:i + n]
        i += n
        assert port.feed(chunk) == jax.feed(chunk)
        assert port.last == jax.last and port.stats == jax.stats
    assert port.stats["packets"] > 10 and port.stats["checksum_errors"] > 0
    assert port.stats["framing_errors"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("timeout_ms", [500, 120])
def test_vehicle_sim_watchdog_traces_are_equal(seed, timeout_ms):
    rng = np.random.default_rng(seed)
    port, jax = P.VehicleSim(timeout_ms), J.VehicleSim(timeout_ms)
    now = 0
    for _ in range(300):
        now += int(rng.integers(0, 3 * timeout_ms // 4))
        if rng.random() < 0.5:
            data = _stream(rng, 1)
            assert port.feed(data, now) == jax.feed(data, now)
        else:
            assert port.tick(now) == jax.tick(now)
        assert port.wheels == jax.wheels
        assert (port.watchdog_stops, port.checksum_errors) == (jax.watchdog_stops,
                                                               jax.checksum_errors)
    assert port.watchdog_stops > 0 and port.checksum_errors > 0


class Recorder:
    def __init__(self):
        self.sent = []

    def send_speeds(self, left, right):
        self.sent.append((left, right))


def test_car_controller_commands_are_equal():
    calls = [("set_wheel_speeds", 1500, -20), ("set_motion", 0.5, 0.5), ("set_motion", 0.5, -1.0),
             ("set_motion", 2.0, 0.005), ("set_speed", 0.3), ("set_steering", 0.7),
             ("forward", 0.8), ("backward", 0.25), ("turn_left", 0.4, 0.5),
             ("turn_right", 0.9, 2.0), ("spin_left", 0.3), ("spin_right", 1.2), ("stop",),
             ("stop",), ("set_wheel_speeds", 300, 300), ("set_wheel_speeds", 300, 300)]
    cars = []
    for mod in (P, J):
        rec = Recorder()
        car = mod.SimpleCarController(transport=rec)
        results = [getattr(car, name)(*args) for name, *args in calls]
        cars.append((rec.sent, results, car.get_current_speeds(), car.is_connected))
    assert cars[0] == cars[1]
    assert (0, 0) in cars[0][0] and len(cars[0][0]) < len(calls)  # repeats suppressed


def test_controller_over_pty_to_vehicle_sim():
    """The port's controller → pty "UART" → the port's VehicleSim, the
    same commands as the JAX package's pair, wheel for wheel."""
    traces = []
    for mod in (P, J):
        master_fd, slave_fd = pty.openpty()
        port = mod.SerialPort(os.ttyname(slave_fd), 115200)
        try:
            car = mod.SimpleCarController(transport=port)
            vehicle = mod.VehicleSim()
            wheels = []
            for i, (name, *args) in enumerate([("forward", 0.5), ("turn_left", 0.4, 0.5),
                                               ("spin_right", 0.3), ("set_motion", 0.6, 0.25),
                                               ("stop",)]):
                assert getattr(car, name)(*args)
                data = os.read(master_fd, 256)
                vehicle.feed(data, now_ms=10 * (i + 1))
                wheels.append(vehicle.wheels)
            assert car.stop()  # a repeat inside the keepalive window: nothing sent
            r, _, _ = select.select([master_fd], [], [], 0.05)
            assert not r
            traces.append(wheels)
        finally:
            port.close()
            os.close(master_fd)
            os.close(slave_fd)
    assert traces[0] == traces[1] == [(500, 500), (200, 400), (300, -300), (480, 720), (0, 0)]
