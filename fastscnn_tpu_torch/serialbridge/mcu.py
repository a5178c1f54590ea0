"""ctypes bindings for the MCU register layer (``mcu.cpp``).

The port's own copy of ``fastscnn_tpu/serialbridge/mcu.py`` and its
firmware source: the STM32-side motor/USART driver logic
(reference:car/motor.c, reference:car/usart.c,
reference:car/simple_car_controller_stm32.c) compiled as host-native C++
over a mock register file. ``Mcu`` is the low-level surface (drivers +
register accessors); ``RegisterVehicle`` adapts the full firmware main
loop to the same ``feed/tick/wheels`` seam as
:class:`fastscnn_tpu_torch.serialbridge.VehicleSim`, so any integration
test or loop that simulates the vehicle can swap in the register-level
firmware.

The library is compiled with ``g++`` the first time it is needed (not at
import), into ``build/fastscnn_tpu_torch/`` under the repo root, named by
a hash of its source and flags, as the bridge library is.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from fastscnn_tpu_torch.utils.native import build_library

__all__ = ["load_mcu", "Mcu", "RegisterVehicle", "WHEELS", "DIRECTIONS"]

_SRC = Path(__file__).resolve().parent / "mcu.cpp"
_LOCK = threading.Lock()
_LIB = None

#: wheel index map for :meth:`Mcu.wheel_velocity` (reference:car/motor.h:9-34)
WHEELS = {"right_front": 0, "left_rear": 1, "right_rear": 2, "left_front": 3}

#: direction command map (reference:car/motor.h:37-40)
DIRECTIONS = {"forward": 0, "back": 1, "left": 2, "right": 3}


def load_mcu() -> ctypes.CDLL:
    """Compile (at first use, when the library for this source is missing)
    and load the MCU firmware library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library(_SRC, "mcufirmware")))
        lib.mcu_new.argtypes = [ctypes.c_int]
        lib.mcu_new.restype = ctypes.c_void_p
        lib.mcu_free.argtypes = [ctypes.c_void_p]
        for fn in ("mcu_motor_gpio_init", "mcu_motor_pwm_init", "mcu_firmware_boot"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.mcu_motor_set_speed.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.mcu_motor_enable.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mcu_motor_set_direction.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mcu_motor_set_direction_with_speed.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
        ]
        lib.mcu_motor_set_differential.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.mcu_usart_init.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.mcu_usart_irq_rx.argtypes = [ctypes.c_void_p, ctypes.c_uint8]
        lib.mcu_usart_set_drop_ff.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mcu_rs232_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.mcu_set_wheel_speeds.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.mcu_firmware_poll.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.mcu_firmware_poll.restype = ctypes.c_int
        for fn in (
            "mcu_gpioa_odr", "mcu_gpiob_odr", "mcu_tim3_arr", "mcu_tim3_psc",
            "mcu_rcc_apb2enr", "mcu_rcc_apb1enr", "mcu_usart_brr",
            "mcu_watchdog_stops", "mcu_checksum_errors", "mcu_protocol_errors",
        ):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_uint32
        lib.mcu_tim3_ccr.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mcu_tim3_ccr.restype = ctypes.c_uint32
        for fn in ("mcu_tim3_enabled", "mcu_rx_len", "mcu_motor_is_enabled"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib.mcu_wheel_velocity.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mcu_wheel_velocity.restype = ctypes.c_int
        for fn in ("mcu_left_speed", "mcu_right_speed"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int16
        lib.mcu_read_tx.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.mcu_read_tx.restype = ctypes.c_int
        _LIB = lib
        return lib


class Mcu:
    """A mock-register STM32 running the reference's driver stack."""

    def __init__(self, rx_ring_len: int = 0):
        """``rx_ring_len`` sets the USART rx ring capacity: pass 5 to model
        usart.h's REC_LEN (whose overflow wrap-at-capacity makes 7-byte
        frames unreceivable — the documented latent reference bug); 0/default
        selects a practical 64-byte ring the firmware loop drains in time."""
        self._lib = load_mcu()
        self._h = self._lib.mcu_new(rx_ring_len)

    # -- motor driver -------------------------------------------------------
    def motor_gpio_init(self):
        self._lib.mcu_motor_gpio_init(self._h)

    def motor_pwm_init(self):
        self._lib.mcu_motor_pwm_init(self._h)

    def motor_set_speed(self, speed: int):
        self._lib.mcu_motor_set_speed(self._h, speed)

    def motor_enable(self, enable: bool):
        self._lib.mcu_motor_enable(self._h, int(enable))

    def motor_set_direction(self, direction: str):
        self._lib.mcu_motor_set_direction(self._h, DIRECTIONS[direction])

    def motor_set_direction_with_speed(self, direction: str, speed: int):
        self._lib.mcu_motor_set_direction_with_speed(self._h, DIRECTIONS[direction], speed)

    def motor_set_differential(self, left: int, right: int):
        self._lib.mcu_motor_set_differential(self._h, left, right)

    # -- usart driver -------------------------------------------------------
    def usart_init(self, baud: int = 115200):
        self._lib.mcu_usart_init(self._h, baud)

    def usart_irq_rx(self, byte: int):
        self._lib.mcu_usart_irq_rx(self._h, byte)

    def usart_set_drop_ff(self, enable: bool):
        """Model reference:car/usart.c:63's unconditional 0xFF drop (a
        latent reference bug for signed speeds; off by default)."""
        self._lib.mcu_usart_set_drop_ff(self._h, int(enable))

    def rs232_send(self, data: bytes):
        self._lib.mcu_rs232_send(self._h, data, len(data))

    # -- firmware main loop -------------------------------------------------
    def boot(self):
        self._lib.mcu_firmware_boot(self._h)

    def set_wheel_speeds(self, left: int, right: int):
        self._lib.mcu_set_wheel_speeds(self._h, left, right)

    def poll(self, data: bytes, now_ms: int) -> int:
        return self._lib.mcu_firmware_poll(self._h, data, len(data), now_ms)

    # -- register surface ---------------------------------------------------
    @property
    def gpioa_odr(self) -> int:
        return self._lib.mcu_gpioa_odr(self._h)

    @property
    def tim3_arr(self) -> int:
        return self._lib.mcu_tim3_arr(self._h)

    @property
    def tim3_psc(self) -> int:
        return self._lib.mcu_tim3_psc(self._h)

    def tim3_ccr(self, channel: int) -> int:
        return self._lib.mcu_tim3_ccr(self._h, channel)

    @property
    def tim3_enabled(self) -> bool:
        return bool(self._lib.mcu_tim3_enabled(self._h))

    @property
    def rcc_apb2enr(self) -> int:
        return self._lib.mcu_rcc_apb2enr(self._h)

    @property
    def rcc_apb1enr(self) -> int:
        return self._lib.mcu_rcc_apb1enr(self._h)

    @property
    def usart_brr(self) -> int:
        return self._lib.mcu_usart_brr(self._h)

    @property
    def rx_len(self) -> int:
        return self._lib.mcu_rx_len(self._h)

    @property
    def motor_enabled(self) -> bool:
        return bool(self._lib.mcu_motor_is_enabled(self._h))

    def wheel_velocity(self, wheel: str) -> int:
        return self._lib.mcu_wheel_velocity(self._h, WHEELS[wheel])

    @property
    def wheel_velocities(self) -> dict[str, int]:
        return {name: self.wheel_velocity(name) for name in WHEELS}

    @property
    def speeds(self) -> tuple[int, int]:
        return (
            self._lib.mcu_left_speed(self._h),
            self._lib.mcu_right_speed(self._h),
        )

    @property
    def watchdog_stops(self) -> int:
        return self._lib.mcu_watchdog_stops(self._h)

    @property
    def checksum_errors(self) -> int:
        return self._lib.mcu_checksum_errors(self._h)

    @property
    def protocol_errors(self) -> int:
        return self._lib.mcu_protocol_errors(self._h)

    def read_tx(self, maxlen: int = 1024) -> bytes:
        buf = ctypes.create_string_buffer(maxlen)
        n = self._lib.mcu_read_tx(self._h, buf, maxlen)
        return buf.raw[:n]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mcu_free(self._h)
            self._h = None


class RegisterVehicle:
    """The register-level firmware behind the VehicleSim seam.

    Same ``feed(data, now_ms) / tick(now_ms) / wheels`` duck-type as
    :class:`fastscnn_tpu_torch.serialbridge.VehicleSim`, but every command flows
    through the USART rx ring, the frame parser, and the TIM3/GPIO
    registers — the wheels reported are derived from CCR duty + direction
    ODR bits, not from a convenience variable.
    """

    def __init__(self, timeout_ms: int = 500):
        if timeout_ms != 500:
            raise ValueError(
                "the register firmware's watchdog is fixed at 500 ms "
                "(reference:car/simple_car_controller_stm32.c:77)"
            )
        self.mcu = Mcu()
        self.mcu.boot()
        self.mcu.read_tx()  # drain the boot banner

    def feed(self, data: bytes, now_ms: int) -> int:
        return self.mcu.poll(data, now_ms)

    def tick(self, now_ms: int) -> bool:
        before = self.mcu.watchdog_stops
        self.mcu.poll(b"", now_ms)
        return self.mcu.watchdog_stops > before

    @property
    def wheels(self) -> tuple[int, int]:
        v = self.mcu.wheel_velocities
        # Left side = left_front/left_rear; both wheels of a side always
        # agree (shared direction bit + duty).
        return (v["left_front"], v["right_front"])

    @property
    def watchdog_stops(self) -> int:
        return self.mcu.watchdog_stops

    @property
    def checksum_errors(self) -> int:
        return self.mcu.checksum_errors
