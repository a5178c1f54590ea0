"""Web dashboard for the realtime pipeline.

The port of ``fastscnn_tpu/interfaces/web_interface.py``, on the standard
library's ``ThreadingHTTPServer``, with the same routes and payloads —

  GET  /                    HTML dashboard
  GET  /video_feed          MJPEG stream of the control map
  GET  /api/stats           pipeline stats JSON, host and card resources
  POST /api/update_params   hot parameter update (queued to the loop)
  POST /api/connect_serial  connect the car controller
  POST /api/start_driving   enable autonomous driving
  POST /api/emergency_stop  immediate stop + disable
  GET  /api/control_status  controller/driving state JSON

Each ``/video_feed`` part is ``Content-Type: image/jpeg``, in the bytes
of the JAX dashboard's PIL branch (``Image.save(bio, "JPEG")`` of the
RGB frame), written by the port's JPEG codec (``data/jpeg.py``) without
PIL or OpenCV. Runs in a daemon thread.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fastscnn_tpu_torch.data.jpeg import encode_jpeg
from fastscnn_tpu_torch.utils.system_monitor import device_stats, host_stats

__all__ = ["DashboardServer"]

_DASHBOARD_HTML = """<!DOCTYPE html>
<html><head><title>fastscnn-tpu-torch dashboard</title>
<style>
 body { font-family: sans-serif; background: #111; color: #eee; margin: 2em; }
 .stat { display: inline-block; margin: 0.5em 1em; }
 button { margin: 0.3em; padding: 0.5em 1em; }
 #estop { background: #c22; color: white; font-weight: bold; }
 img { border: 1px solid #444; max-width: 100%; }
</style></head>
<body>
<h2>fastscnn-tpu-torch realtime dashboard</h2>
<div id="stats"></div>
<div id="system" style="color:#9c9"></div>
<div>
 <button onclick="api('start_driving')">Start driving</button>
 <button id="estop" onclick="api('emergency_stop')">EMERGENCY STOP</button>
</div>
<div id="params">
 steering gain <input id="steering_gain" size="5">
 base pwm <input id="base_pwm" size="5">
 preview distance <input id="preview_distance" size="5">
 curvature damping <input id="curvature_damping" size="5">
 min pwm <input id="min_pwm" size="5">
 max pwm <input id="max_pwm" size="5">
 ema alpha <input id="ema_alpha" size="5">
 smoothing <input type="checkbox" id="enable_smoothing">
 <button onclick="updateParams()">Update params</button>
</div>
<img src="/video_feed" width="640">
<script>
const NUM_PARAMS = ['steering_gain','base_pwm','preview_distance',
                    'curvature_damping','min_pwm','max_pwm','ema_alpha'];
async function api(name) { await fetch('/api/' + name, {method: 'POST'}); }
let statusLoaded = false;
async function updateParams() {
  const body = {};
  for (const k of NUM_PARAMS) {
    const v = document.getElementById(k).value;
    if (v) body[k] = parseFloat(v);
  }
  // Only send the toggle once the checkbox reflects real server state:
  // before loadControlStatus resolves (or if it failed) an unchecked
  // default would silently disable smoothing on any numeric tweak.
  if (statusLoaded)
    body.enable_smoothing = document.getElementById('enable_smoothing').checked;
  await fetch('/api/update_params', {method: 'POST', body: JSON.stringify(body)});
}
async function loadControlStatus() {
  const s = await (await fetch('/api/control_status')).json();
  for (const k of NUM_PARAMS) {
    const el = document.getElementById(k);
    if (!el.value && s[k] != null) el.value = s[k];
  }
  document.getElementById('enable_smoothing').checked = !!s.enable_smoothing;
  statusLoaded = true;
}
loadControlStatus();
setInterval(async () => {
  const s = await (await fetch('/api/stats')).json();
  const sys = s.system || {}, dev = s.device || {};
  delete s.system; delete s.device;
  document.getElementById('stats').innerText = JSON.stringify(s);
  let line = `host: cpu ${sys.cpu_percent ?? '?'}% mem ${sys.mem_percent ?? '?'}%`;
  if (dev.platform) {
    line += ` | ${dev.device_kind || dev.platform}`;
    if (dev.bytes_in_use != null)
      line += `: ${(dev.bytes_in_use / 1048576).toFixed(0)} MiB` +
              (dev.mem_percent != null ? ` (${dev.mem_percent}%)` : '');
  }
  document.getElementById('system').innerText = line;
}, 500);
</script>
</body></html>
"""


def _encode_jpeg(img) -> bytes | None:
    """A BGR (or greyscale) frame as JPEG bytes: the channels flipped to
    RGB and Pillow's ``save(bio, "JPEG")`` bytes (quality 75)."""
    if img is None:
        return None
    return encode_jpeg(img[..., ::-1] if img.ndim == 3 else img)


class DashboardServer:
    def __init__(self, pipeline, host="0.0.0.0", port=5000, car_factory=None):
        self.pipeline = pipeline
        self.host = host
        self.port = port
        self.car_factory = car_factory
        self.httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- request handling -----------------------------------------------------
    def _make_handler(server_self):
        pipeline = server_self.pipeline

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
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
                    data = _DASHBOARD_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/api/stats":
                    stats = pipeline.get_stats()
                    stats.pop("control_map", None)
                    stats.pop("visualization", None)
                    # system monitor: host CPU/mem plus the card's memory
                    # from PyTorch's CUDA runtime (never initialises CUDA)
                    stats["system"] = host_stats()
                    stats["device"] = device_stats()
                    self._json(stats)
                elif self.path == "/api/control_status":
                    ctrl = pipeline.controller
                    self._json(
                        {
                            "driving_enabled": pipeline.driving_enabled,
                            "emergency_stopped": pipeline.emergency_stopped,
                            "serial_connected": pipeline.car is not None
                            and getattr(pipeline.car, "is_connected", False),
                            "steering_gain": ctrl.steering_gain,
                            "base_pwm": ctrl.base_pwm,
                            "curvature_damping": ctrl.curvature_damping,
                            "preview_distance": ctrl.preview_distance,
                            "min_pwm": ctrl.min_pwm,
                            "max_pwm": ctrl.max_pwm,
                            "ema_alpha": ctrl.ema_alpha,
                            "enable_smoothing": ctrl.enable_smoothing,
                        }
                    )
                elif self.path == "/video_feed":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "multipart/x-mixed-replace; boundary=frame"
                    )
                    self.end_headers()
                    try:
                        while pipeline.running:
                            with pipeline.web_data_lock:
                                img = pipeline.web_data.get("control_map")
                                if img is None:
                                    img = pipeline.web_data.get("visualization")
                            jpeg = _encode_jpeg(img)
                            if jpeg is not None:
                                self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n\r\n")
                                self.wfile.write(jpeg)
                                self.wfile.write(b"\r\n")
                            time.sleep(0.1)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(body or b"{}")
                except json.JSONDecodeError:
                    payload = {}
                if self.path == "/api/update_params":
                    pipeline.update_params(payload)
                    self._json({"status": "ok", "updated": list(payload)})
                elif self.path == "/api/start_driving":
                    pipeline.start_driving()
                    self._json({"status": "ok", "driving": True})
                elif self.path == "/api/emergency_stop":
                    pipeline.emergency_stop()
                    self._json({"status": "ok", "stopped": True})
                elif self.path == "/api/connect_serial":
                    if pipeline.car is None and server_self.car_factory is not None:
                        pipeline.car = server_self.car_factory()
                    ok = pipeline.car is not None and (
                        getattr(pipeline.car, "is_connected", False) or pipeline.car.connect()
                    )
                    self._json({"status": "ok" if ok else "error", "connected": bool(ok)})
                else:
                    self._json({"error": "not found"}, 404)

        return Handler

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        self.httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
