#!/usr/bin/env python3
"""Car-control API usage example, on the port's serial bridge.

    python -m fastscnn_tpu_torch.examples.car_control_example [--port DEV]
        [--baudrate 115200]

The port of the repo root's ``examples/car_control_example.py`` (itself a
port of the reference's ``car_control_example.py``), over
``fastscnn_tpu_torch.serialbridge``: ``SimpleCarController`` drives a
forward run, an S-curve through ``set_motion`` and a spin, then stops.
With ``--port`` it talks to a real serial device; without it, to the
in-process firmware simulator (``VehicleSim``), printing the wheels after
every command. Host only: it runs no kernel and touches no device.
"""

import argparse
import math
import time

from fastscnn_tpu_torch.serialbridge import SimpleCarController, VehicleSim, pack_packet


class SimTransport:
    """Loopback transport feeding the firmware-equivalent VehicleSim."""

    def __init__(self):
        self.vehicle = VehicleSim()
        self.t0 = time.time()

    def send_speeds(self, left, right):
        now_ms = int((time.time() - self.t0) * 1000)
        self.vehicle.feed(pack_packet(left, right), now_ms)
        print(f"  -> wheels now {self.vehicle.wheels}")


def demo_simple(car: SimpleCarController):
    print("forward 50%")
    car.forward(0.5)
    time.sleep(0.2)
    print("gentle S-curve via set_motion")
    for t in range(10):
        car.set_motion(0.4, 0.6 * math.sin(t / 3.0))
        time.sleep(0.1)
    print("spin left, then stop")
    car.spin_left(0.3)
    time.sleep(0.2)
    car.stop()


def main(argv=None):
    """The demo; returns the controller's transport (a
    :class:`SimTransport`, which holds the simulated vehicle, when no
    ``--port`` was given)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", default=None, help="serial device (default: simulator)")
    parser.add_argument("--baudrate", type=int, default=115200)
    args = parser.parse_args(argv)

    if args.port:
        car = SimpleCarController(port=args.port, baudrate=args.baudrate)
        if not car.connect():
            raise SystemExit(f"cannot open {args.port}")
    else:
        print("no --port given: driving the firmware simulator")
        car = SimpleCarController(transport=SimTransport())
    transport = car.serial

    try:
        demo_simple(car)
    finally:
        car.stop()
        car.disconnect()
    return transport


if __name__ == "__main__":
    main()
