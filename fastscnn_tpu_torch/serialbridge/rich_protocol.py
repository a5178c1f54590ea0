"""Rich framed car-control protocol.

The port's own copy of ``fastscnn_tpu/serialbridge/rich_protocol.py``, a
port of the reference's second (command-framed) serial protocol
(reference:car_controller.py:19-488): packets are

  0xAA | cmd_type | len | payload... | checksum | 0x55

with checksum = sum(cmd_type, len, payload) & 0xFF, and command types
SET_SPEED(0x01, <H pwm), SET_STEERING(0x02, <ff ratios),
SET_MOTION(0x03, <HHH pwm,left,right), EMERGENCY_STOP(0x04),
GET_STATUS(0x05), ACK(0x06).

``CarController`` reproduces the reference host class including the
steering→wheel-ratio math (ratio = 1 ∓ steering·0.5, clamped to
[0.3, 1.0], reference:car_controller.py:181-200) and no-op suppression.
``RichVehicleSim`` is the matching device side for hardware-free tests.
"""

from __future__ import annotations

import struct
import threading
import time

__all__ = ["CarController", "RichVehicleSim", "frame_command", "parse_frames"]

PROTOCOL_HEADER = 0xAA
PROTOCOL_TAIL = 0x55

CMD_SET_SPEED = 0x01
CMD_SET_STEERING = 0x02
CMD_SET_MOTION = 0x03
CMD_EMERGENCY_STOP = 0x04
CMD_GET_STATUS = 0x05
CMD_ACK = 0x06

MODE_STOP = 0x00
MODE_FORWARD = 0x01
MODE_DIFFERENTIAL = 0x05


def frame_command(cmd_type: int, data: bytes = b"") -> bytes:
    """reference:car_controller.py:334-341."""
    packet = struct.pack("<BB", PROTOCOL_HEADER, cmd_type)
    packet += struct.pack("<B", len(data))
    packet += bytes(data)
    checksum = sum(packet[1:]) & 0xFF
    packet += struct.pack("<B", checksum)
    packet += struct.pack("<B", PROTOCOL_TAIL)
    return packet


# every reference command carries a handful of bytes; anything claiming a
# longer payload is line noise misread as a header (see parse_frames)
MAX_PAYLOAD = 32


def parse_frames(buffer: bytearray):
    """Consume complete frames from ``buffer``; yields (cmd, payload).
    Invalid frames (bad checksum/tail) are skipped with resync."""
    frames = []
    while True:
        # find header
        while buffer and buffer[0] != PROTOCOL_HEADER:
            buffer.pop(0)
        if len(buffer) < 5:
            return frames
        length = buffer[2]
        if length > MAX_PAYLOAD:
            # a noise byte that happened to equal the header, followed by
            # a garbage "length": waiting for the phantom bytes would
            # stall real frames already behind it — resync instead
            buffer.pop(0)
            continue
        total = 5 + length
        if len(buffer) < total:
            return frames
        frame = bytes(buffer[:total])
        cmd = frame[1]
        payload = frame[3 : 3 + length]
        checksum = frame[3 + length]
        tail = frame[4 + length]
        del buffer[:1]  # always advance at least one byte
        if tail == PROTOCOL_TAIL and checksum == (sum(frame[1 : 3 + length]) & 0xFF):
            del buffer[: total - 1]
            frames.append((cmd, payload))


def _steering_ratios(steering: float) -> tuple[float, float]:
    """reference:car_controller.py:181-200 / 234-242."""
    if abs(steering) < 0.01:
        return 1.0, 1.0
    left = max(0.3, min(1.0, 1.0 - steering * 0.5))
    right = max(0.3, min(1.0, 1.0 + steering * 0.5))
    return left, right


class CarController:
    """Host-side rich-protocol controller (speed/steering abstraction)."""

    def __init__(self, port="/dev/ttyAMA0", baudrate=115200, timeout=1.0, transport=None):
        self.port = port
        self.baudrate = baudrate
        self.timeout = timeout
        self.serial = transport
        self.is_connected = transport is not None
        self.lock = threading.Lock()
        self.current_speed = 0.0
        self.current_steering = 0.0
        self.current_mode = MODE_STOP
        self.max_wheel_speed = 1000
        self.last_command_time = 0.0
        self.command_timeout = 0.5
        if self.is_connected:
            self._send_init_command()

    def connect(self) -> bool:
        if self.is_connected:
            return True
        try:
            from fastscnn_tpu_torch.serialbridge import SerialPort

            self.serial = SerialPort(self.port, self.baudrate)
            self.is_connected = True
            self._send_init_command()
            return True
        except OSError:
            return False

    def disconnect(self):
        if self.serial is not None and hasattr(self.serial, "close"):
            self.serial.close()
        self.serial = None
        self.is_connected = False

    def _send_init_command(self):
        self._send_command(CMD_EMERGENCY_STOP, b"")

    def _send_command(self, cmd_type: int, data: bytes) -> bool:
        if not self.is_connected or self.serial is None:
            return False
        with self.lock:
            self.serial.write(frame_command(cmd_type, data))
            return True

    # -- public API ----------------------------------------------------------
    def set_speed(self, speed: float) -> bool:
        speed = max(0.0, min(1.0, speed))
        pwm = int(speed * self.max_wheel_speed)
        if self._send_command(CMD_SET_SPEED, struct.pack("<H", pwm)):
            self.current_speed = speed
            self.current_mode = MODE_FORWARD if pwm else MODE_STOP
            self.last_command_time = time.time()
            return True
        return False

    def set_steering(self, steering: float) -> bool:
        steering = max(-1.0, min(1.0, steering))
        if abs(steering - self.current_steering) < 0.01:
            return True
        left, right = _steering_ratios(steering)
        if self._send_command(CMD_SET_STEERING, struct.pack("<ff", left, right)):
            self.current_steering = steering
            self.last_command_time = time.time()
            return True
        return False

    def set_motion(self, speed: float, steering: float) -> bool:
        speed = max(0.0, min(1.0, speed))
        steering = max(-1.0, min(1.0, steering))
        pwm = int(speed * self.max_wheel_speed)
        left_ratio, right_ratio = _steering_ratios(steering)
        left_pwm = int(pwm * left_ratio)
        right_pwm = int(pwm * right_ratio)
        if self._send_command(CMD_SET_MOTION, struct.pack("<HHH", pwm, left_pwm, right_pwm)):
            self.current_speed = speed
            self.current_steering = steering
            self.current_mode = MODE_DIFFERENTIAL
            self.last_command_time = time.time()
            return True
        return False

    def stop(self) -> bool:
        if self._send_command(CMD_EMERGENCY_STOP, b""):
            self.current_speed = 0.0
            self.current_steering = 0.0
            self.current_mode = MODE_STOP
            self.last_command_time = time.time()
            return True
        return False

    emergency_stop = stop

    def get_status(self):
        if not self._send_command(CMD_GET_STATUS, b""):
            return None
        if hasattr(self.serial, "read"):
            response = self.serial.read(16, timeout_ms=int(self.timeout * 1000))
            if response and len(response) >= 8:
                status = struct.unpack("<HHHH", response[:8])
                return {
                    "left_front_speed": status[0],
                    "left_rear_speed": status[1],
                    "right_front_speed": status[2],
                    "right_rear_speed": status[3],
                    "current_speed": self.current_speed,
                    "current_steering": self.current_steering,
                    "mode": self.current_mode,
                }
        return None

    def is_command_timeout(self) -> bool:
        return time.time() - self.last_command_time > self.command_timeout

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.disconnect()


class RichVehicleSim:
    """Device-side interpreter of the rich protocol for tests: tracks the
    four wheel PWMs and answers GET_STATUS."""

    def __init__(self):
        self.buffer = bytearray()
        self.wheels = [0, 0, 0, 0]  # LF, LR, RF, RR
        self.stopped = True
        self.responses = bytearray()

    def feed(self, data: bytes) -> int:
        self.buffer.extend(data)
        frames = parse_frames(self.buffer)
        for cmd, payload in frames:
            if cmd == CMD_SET_SPEED:
                (pwm,) = struct.unpack("<H", payload)
                self.wheels = [pwm] * 4
                self.stopped = pwm == 0
            elif cmd == CMD_SET_STEERING:
                left_ratio, right_ratio = struct.unpack("<ff", payload)
                base = max(self.wheels) or 0
                self.wheels = [int(base * left_ratio)] * 2 + [int(base * right_ratio)] * 2
            elif cmd == CMD_SET_MOTION:
                _, left_pwm, right_pwm = struct.unpack("<HHH", payload)
                self.wheels = [left_pwm, left_pwm, right_pwm, right_pwm]
                self.stopped = left_pwm == 0 and right_pwm == 0
            elif cmd == CMD_EMERGENCY_STOP:
                self.wheels = [0, 0, 0, 0]
                self.stopped = True
            elif cmd == CMD_GET_STATUS:
                self.responses += struct.pack("<HHHH", *self.wheels)
        return len(frames)
