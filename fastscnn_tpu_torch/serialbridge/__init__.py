"""Native serial/actuation bridge with ctypes bindings.

The port's own copy of ``fastscnn_tpu/serialbridge/__init__.py`` and its
C++ library (``bridge.cpp``): the UART wheel-speed protocol (pack,
parse, checksum), a firmware-equivalent ``VehicleSim`` with the 500 ms
command watchdog, and raw termios serial I/O. The library is compiled
with ``g++`` the first time a function needs it (not at import), into
``build/fastscnn_tpu_torch/`` under the repo root, named by a hash of
its source and flags.

``SimpleCarController`` is the host API of the reference's car
controller: connect/disconnect, set_wheel_speeds, set_motion/speed/
steering, forward/backward/turn/spin/stop, context manager, command
timeout tracking — packing and sending through the native bridge.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = [
    "load_bridge",
    "pack_packet",
    "unpack_packet",
    "Parser",
    "VehicleSim",
    "SerialPort",
    "SimpleCarController",
]

_SRC = Path(__file__).resolve().parent / "bridge.cpp"
# under the repo root's git-ignored build/, beside the CUDA kernels' libraries
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fastscnn_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None


def build_library(src: Path, name: str) -> Path:
    """The shared library of the C++ source ``src``, compiled with ``g++``
    when the one for this source and :data:`GXX_FLAGS` is missing, into
    ``BUILD_DIR/lib<name>-<hash>.so``. The caller holds its own lock."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {src.name} (rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: no other process loads a partial library
    return so


def load_bridge() -> ctypes.CDLL:
    """Compile (at first use, when the library for this source is missing)
    and load the native bridge library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library(_SRC, "serialbridge")))
        # signatures
        lib.sb_pack.argtypes = [ctypes.c_int16, ctypes.c_int16, ctypes.c_char_p]
        lib.sb_pack.restype = ctypes.c_int
        lib.sb_unpack.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int16),
        ]
        lib.sb_unpack.restype = ctypes.c_int
        lib.sb_parser_new.restype = ctypes.c_void_p
        lib.sb_parser_free.argtypes = [ctypes.c_void_p]
        lib.sb_parser_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.sb_parser_feed.restype = ctypes.c_int
        for fn in ("sb_parser_last_left", "sb_parser_last_right"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int16
        for fn in ("sb_parser_packets", "sb_parser_checksum_errors", "sb_parser_framing_errors"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_uint32
        lib.sb_vehicle_new.argtypes = [ctypes.c_uint32]
        lib.sb_vehicle_new.restype = ctypes.c_void_p
        lib.sb_vehicle_free.argtypes = [ctypes.c_void_p]
        lib.sb_vehicle_feed.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_uint64,
        ]
        lib.sb_vehicle_feed.restype = ctypes.c_int
        lib.sb_vehicle_tick.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.sb_vehicle_tick.restype = ctypes.c_int
        for fn in ("sb_vehicle_left", "sb_vehicle_right"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int16
        for fn in ("sb_vehicle_watchdog_stops", "sb_vehicle_checksum_errors"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_uint32
        lib.sb_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.sb_open.restype = ctypes.c_int
        lib.sb_send.argtypes = [ctypes.c_int, ctypes.c_int16, ctypes.c_int16]
        lib.sb_send.restype = ctypes.c_int
        lib.sb_read.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.sb_read.restype = ctypes.c_int
        lib.sb_close.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib


def pack_packet(left: int, right: int) -> bytes:
    lib = load_bridge()
    buf = ctypes.create_string_buffer(7)
    lib.sb_pack(left, right, buf)
    return buf.raw


def unpack_packet(packet: bytes):
    lib = load_bridge()
    left = ctypes.c_int16()
    right = ctypes.c_int16()
    ok = lib.sb_unpack(packet, ctypes.byref(left), ctypes.byref(right))
    return (left.value, right.value) if ok else None


class Parser:
    """Streaming packet parser (native state machine)."""

    def __init__(self):
        self._lib = load_bridge()
        self._h = self._lib.sb_parser_new()

    def feed(self, data: bytes) -> int:
        return self._lib.sb_parser_feed(self._h, data, len(data))

    @property
    def last(self):
        return (
            self._lib.sb_parser_last_left(self._h),
            self._lib.sb_parser_last_right(self._h),
        )

    @property
    def stats(self):
        return {
            "packets": self._lib.sb_parser_packets(self._h),
            "checksum_errors": self._lib.sb_parser_checksum_errors(self._h),
            "framing_errors": self._lib.sb_parser_framing_errors(self._h),
        }

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sb_parser_free(self._h)
            self._h = None


class VehicleSim:
    """Firmware-equivalent vehicle: parse → clamp → set wheels → watchdog."""

    def __init__(self, timeout_ms: int = 500):
        self._lib = load_bridge()
        self._h = self._lib.sb_vehicle_new(timeout_ms)

    def feed(self, data: bytes, now_ms: int) -> int:
        return self._lib.sb_vehicle_feed(self._h, data, len(data), now_ms)

    def tick(self, now_ms: int) -> bool:
        return bool(self._lib.sb_vehicle_tick(self._h, now_ms))

    @property
    def wheels(self):
        return (self._lib.sb_vehicle_left(self._h), self._lib.sb_vehicle_right(self._h))

    @property
    def watchdog_stops(self):
        return self._lib.sb_vehicle_watchdog_stops(self._h)

    @property
    def checksum_errors(self):
        return self._lib.sb_vehicle_checksum_errors(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sb_vehicle_free(self._h)
            self._h = None


class SerialPort:
    """Raw 8N1 serial port through the native bridge (termios)."""

    def __init__(self, device: str, baudrate: int = 115200):
        self._lib = load_bridge()
        self.fd = self._lib.sb_open(device.encode(), baudrate)
        if self.fd < 0:
            raise OSError(f"cannot open serial device {device}")

    def send_speeds(self, left: int, right: int):
        if self._lib.sb_send(self.fd, left, right) != 7:
            raise OSError("short write on serial port")

    def write(self, data: bytes):
        os.write(self.fd, data)

    def read(self, maxlen: int = 256, timeout_ms: int = 100) -> bytes:
        buf = ctypes.create_string_buffer(maxlen)
        n = self._lib.sb_read(self.fd, buf, maxlen, timeout_ms)
        return buf.raw[:n] if n > 0 else b""

    def close(self):
        if self.fd >= 0:
            self._lib.sb_close(self.fd)
            self.fd = -1


class SimpleCarController:
    """Host-side car controller over the native bridge.

    API-compatible with the reference's SimpleCarController
    (reference:kuruma/car_controller_simple.py): same speed clamping,
    no-op suppression of repeated speeds, set_motion steering math
    (0.8 turn-strength coefficient), helper motions, and 0.5 s command
    timeout bookkeeping that mirrors the firmware watchdog.
    """

    PROTOCOL_HEADER = 0xAA
    PROTOCOL_TAIL = 0x55

    def __init__(self, port="/dev/ttyAMA0", baudrate=115200, timeout=1.0, transport=None):
        self.port = port
        self.baudrate = baudrate
        self.timeout = timeout
        self.serial = transport  # injected transport (tests) or None
        self.is_connected = transport is not None
        self.left_wheel_speed = 0
        self.right_wheel_speed = 0
        self.max_speed = 1000
        self.min_speed = -1000
        self.last_command_time = 0.0
        self.command_timeout = 0.5
        self.lock = threading.Lock()

    # -- connection ----------------------------------------------------------
    def connect(self) -> bool:
        if self.is_connected:
            return True
        try:
            self.serial = SerialPort(self.port, self.baudrate)
            self.is_connected = True
            return True
        except OSError:
            return False

    def disconnect(self):
        if self.serial is not None and hasattr(self.serial, "close"):
            self.serial.close()
        self.serial = None
        self.is_connected = False

    # -- low level -----------------------------------------------------------
    def _send_speed_command(self, left_speed: int, right_speed: int) -> bool:
        if not self.is_connected or self.serial is None:
            return False
        with self.lock:
            try:
                if hasattr(self.serial, "send_speeds"):
                    self.serial.send_speeds(left_speed, right_speed)
                else:  # duck-typed transport with .write
                    self.serial.write(pack_packet(left_speed, right_speed))
            except OSError as e:
                # transient link failure: warn-and-continue like the camera
                # path (the firmware watchdog is the safety net); the next
                # frame retries because the cached speeds stay unchanged
                logger.warning("serial send failed: %s", e)
                return False
            return True

    # -- public API (reference-parity) ----------------------------------------
    def set_wheel_speeds(self, left_speed: int, right_speed: int) -> bool:
        left_speed = max(self.min_speed, min(self.max_speed, left_speed))
        right_speed = max(self.min_speed, min(self.max_speed, right_speed))
        if left_speed == self.left_wheel_speed and right_speed == self.right_wheel_speed:
            # Identical command: still KEEPALIVE before the firmware's
            # 500 ms silence watchdog fires (car/simple_car_controller
            # _stm32.c:74-81 auto-stops) — suppressing all repeats would
            # stop the car on any constant-speed stretch.
            if time.time() - self.last_command_time < self.command_timeout / 2:
                return True
        ok = self._send_speed_command(left_speed, right_speed)
        if ok:
            self.left_wheel_speed = left_speed
            self.right_wheel_speed = right_speed
            self.last_command_time = time.time()
        return ok

    def set_motion(self, speed: float, steering: float) -> bool:
        speed = max(0.0, min(1.0, speed))
        steering = max(-1.0, min(1.0, steering))
        base_speed = int(speed * self.max_speed)
        if abs(steering) < 0.01:
            left_speed = right_speed = base_speed
        else:
            speed_diff = int(base_speed * steering * 0.8)
            left_speed = max(self.min_speed, min(self.max_speed, base_speed - speed_diff))
            right_speed = max(self.min_speed, min(self.max_speed, base_speed + speed_diff))
        return self.set_wheel_speeds(left_speed, right_speed)

    def set_speed(self, speed: float) -> bool:
        return self.set_motion(speed, 0.0)

    def set_steering(self, steering: float) -> bool:
        current = max(abs(self.left_wheel_speed), abs(self.right_wheel_speed)) / self.max_speed
        return self.set_motion(current, steering)

    def stop(self) -> bool:
        return self.set_wheel_speeds(0, 0)

    def forward(self, speed: float) -> bool:
        base = int(max(0.0, min(1.0, speed)) * self.max_speed)
        return self.set_wheel_speeds(base, base)

    def backward(self, speed: float) -> bool:
        base = int(max(0.0, min(1.0, speed)) * self.max_speed)
        return self.set_wheel_speeds(-base, -base)

    def turn_left(self, speed: float, turn_intensity: float = 0.5) -> bool:
        base = int(max(0.0, min(1.0, speed)) * self.max_speed)
        inner = int(base * (1 - max(0.0, min(1.0, turn_intensity))))
        return self.set_wheel_speeds(inner, base)

    def turn_right(self, speed: float, turn_intensity: float = 0.5) -> bool:
        base = int(max(0.0, min(1.0, speed)) * self.max_speed)
        inner = int(base * (1 - max(0.0, min(1.0, turn_intensity))))
        return self.set_wheel_speeds(base, inner)

    def spin_left(self, speed: float) -> bool:
        base = int(max(0.0, min(1.0, speed)) * self.max_speed)
        return self.set_wheel_speeds(-base, base)

    def spin_right(self, speed: float) -> bool:
        base = int(max(0.0, min(1.0, speed)) * self.max_speed)
        return self.set_wheel_speeds(base, -base)

    def get_current_speeds(self):
        return self.left_wheel_speed, self.right_wheel_speed

    def get_current_state(self) -> dict:
        return {
            "left_wheel_speed": self.left_wheel_speed,
            "right_wheel_speed": self.right_wheel_speed,
            "connected": self.is_connected,
            "last_command_time": self.last_command_time,
            "command_timeout": self.is_command_timeout(),
        }

    def is_command_timeout(self) -> bool:
        return time.time() - self.last_command_time > self.command_timeout

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.disconnect()
