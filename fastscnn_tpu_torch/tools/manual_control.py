"""Manual car control — keyboard teleop + web wheel-speed page.

The port's own copy of ``fastscnn_tpu/tools/manual_control.py``: ports of
reference:manual_control.py (w/s/a/d char teleop over serial)
and reference:web_car_controller.py (Flask manual wheel-speed page) on
the stdlib. Both drive the native-serial SimpleCarController.

Usage::

    python -m fastscnn_tpu_torch.tools.manual_control keyboard --port /dev/ttyAMA0
    python -m fastscnn_tpu_torch.tools.manual_control web --port /dev/ttyAMA0
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fastscnn_tpu_torch.serialbridge import SimpleCarController

__all__ = ["teleop_step", "WebCarServer", "main"]

# key → (speed, steering) like the reference's w/s/a/d teleop
_KEY_ACTIONS = {
    "w": ("forward", 0.5),
    "s": ("backward", 0.5),
    "a": ("turn_left", 0.4),
    "d": ("turn_right", 0.4),
    "q": ("spin_left", 0.4),
    "e": ("spin_right", 0.4),
    " ": ("stop", None),
    "x": ("stop", None),
}


def teleop_step(car: SimpleCarController, key: str) -> bool:
    """Apply one teleop keypress; returns False if the key means quit."""
    key = key.lower()
    if key in ("\x03", "\x04", "z"):
        car.stop()
        return False
    action = _KEY_ACTIONS.get(key)
    if action is None:
        return True
    name, speed = action
    method = getattr(car, name)
    if speed is None:
        method()
    elif name.startswith("turn"):
        method(speed, 0.6)
    else:
        method(speed)
    return True


def _keyboard_loop(car):  # pragma: no cover - needs a tty
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    print("teleop: w/s/a/d move, q/e spin, space stop, z quit")
    try:
        tty.setcbreak(fd)
        while True:
            key = sys.stdin.read(1)
            if not teleop_step(car, key):
                break
            l, r = car.get_current_speeds()
            print(f"\rL={l:+5d} R={r:+5d}  ", end="", flush=True)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        car.stop()


_PAGE = """<!DOCTYPE html><html><head><title>car control</title><style>
 body{font-family:sans-serif;background:#222;color:#eee;text-align:center}
 button{width:90px;height:60px;margin:4px;font-size:1.1em}
 #stop{background:#c22;color:#fff;width:200px}
 input{width:70px}
</style></head><body>
<h3>manual car control <span id="st"></span></h3>
<div><button onclick="act('forward')">&#8593;</button></div>
<div>
 <button onclick="act('turn_left')">&#8634;</button>
 <button id="stop" onclick="act('stop')">STOP</button>
 <button onclick="act('turn_right')">&#8635;</button>
</div>
<div><button onclick="act('backward')">&#8595;</button></div>
<div>speed <input id="speed" value="0.5"> |
 L <input id="l" value="0"> R <input id="r" value="0">
 <button onclick="wheels()">set wheels</button></div>
<script>
async function act(name){
  const speed=parseFloat(document.getElementById('speed').value);
  const r=await fetch('/api/'+name,{method:'POST',body:JSON.stringify({speed})});
  document.getElementById('st').innerText=JSON.stringify(await r.json());
}
async function wheels(){
  const l=parseInt(document.getElementById('l').value);
  const r=parseInt(document.getElementById('r').value);
  const resp=await fetch('/api/wheels',{method:'POST',body:JSON.stringify({left:l,right:r})});
  document.getElementById('st').innerText=JSON.stringify(await resp.json());
}
</script></body></html>"""


class WebCarServer:
    """Stdlib web page wrapping SimpleCarController
    (reference:web_car_controller.py)."""

    def __init__(self, car: SimpleCarController, host="0.0.0.0", port=5001):
        self.car = car
        self.host = host
        self.port = port
        self.httpd = None
        self._thread = None

    def _handler(server_self):
        car = server_self.car

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, payload, code=200):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/":
                    data = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/api/state":
                    self._json(car.get_current_state())
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    payload = {}
                speed = float(payload.get("speed", 0.5))
                name = self.path[len("/api/") :]
                if name == "wheels":
                    ok = car.set_wheel_speeds(
                        int(payload.get("left", 0)), int(payload.get("right", 0))
                    )
                elif name in ("forward", "backward", "spin_left", "spin_right"):
                    ok = getattr(car, name)(speed)
                elif name in ("turn_left", "turn_right"):
                    ok = getattr(car, name)(speed, float(payload.get("intensity", 0.5)))
                elif name == "stop":
                    ok = car.stop()
                else:
                    self._json({"error": "not found"}, 404)
                    return
                l, r = car.get_current_speeds()
                self._json({"ok": bool(ok), "left": l, "right": r})

        return Handler

    def start(self):
        self.httpd = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None


def main(argv=None):
    parser = argparse.ArgumentParser(description="manual car control")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("keyboard", "web"):
        p = sub.add_parser(name)
        p.add_argument("--port", default="/dev/ttyAMA0")
        p.add_argument("--baudrate", type=int, default=115200)
        if name == "web":
            p.add_argument("--http-port", type=int, default=5001)
    args = parser.parse_args(argv)
    car = SimpleCarController(port=args.port, baudrate=args.baudrate)
    if not car.connect():
        raise SystemExit(f"cannot open {args.port}")
    try:
        if args.cmd == "keyboard":
            _keyboard_loop(car)
        else:
            server = WebCarServer(car, port=args.http_port)
            port = server.start()
            print(f"web car control at http://0.0.0.0:{port}/ (Ctrl-C to stop)")
            server._thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        car.stop()
        car.disconnect()


if __name__ == "__main__":
    main()
