"""Web annotation server — mask painting in the browser: counterpart of
``fastscnn_tpu/tools/annotation_server.py``, with the same page and routes.

Port of the Flask annotation servers (reference:web_annotation_server.py,
reference:improved_web_annotation.py, reference:web_annotation_simple.py)
on the standard library: serves images from ``--images-dir`` one at a
time with an HTML5 canvas (pen/eraser, brush size, undo/redo via
client-side history — iPad/Pencil friendly like the reference's
start_web_annotation.py notes), and saves painted masks as binary PNGs
into ``--masks-dir``.

The "improved" variant's extras (reference:improved_web_annotation.py:1-12)
are provided too: existing masks load back into the canvas for editing,
an auto-fill action converts painted lane *lines* into the filled
drivable region between them (morphology + row fill, shared with
``tools.dataset_tools.convert_lane_to_drivable_mask``), and batch
operations (MD5 image dedup, delete mask, convert-all-masks) run from
the same page.

Routes:
  GET  /                 annotation UI
  GET  /api/images       list of images + which already have masks
  GET  /image/<name>     raw image bytes
  GET  /mask/<name>      existing mask as a red RGBA overlay PNG (404 if none)
  POST /api/save_mask    {"name": ..., "mask_png_base64": ...}
  POST /api/auto_fill    {"mask_png_base64": ...} → filled overlay PNG b64
  POST /api/batch        {"op": "dedupe" | "delete_mask" | "lane2drivable_all", ...}

Usage::

    python -m fastscnn_tpu_torch.tools.annotation_server \
        --images-dir data/custom/images --masks-dir data/custom/masks

No PIL: the canvas PNGs are read with ``data/image_io.py`` (its
``convert='RGBA'`` is Pillow's, ``tRNS`` included), masks with its
``convert='L'`` (a JPEG mask, as auto-fill and ``lane2drivable_all`` may
meet, through the port's JPEG codec), and every PNG is written by
``image_io.write_png``. A PNG's pixels are Pillow's; its compressed
bytes are not.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.tools.dataset_tools import (
    convert_lane_to_drivable_mask,
    dedupe_images,
)

__all__ = [
    "AnnotationServer",
    "save_mask_from_base64",
    "auto_fill_from_base64",
    "mask_to_overlay_png_b64",
    "mask_to_overlay_png_bytes",
]

_PAGE = """<!DOCTYPE html>
<html><head><title>mask annotation</title>
<style>
 body { font-family: sans-serif; margin: 1em; background:#222; color:#eee; }
 #wrap { position: relative; display:inline-block; }
 #photo, #paint { position:absolute; left:0; top:0; }
 #wrap, #photo, #paint { touch-action: none; }
 #paint { opacity: 0.5; }
 button, select { margin:0.2em; padding:0.4em 0.8em; }
</style></head><body>
<h3>mask annotation <span id="status"></span></h3>
<div>
 <select id="files"></select>
 <button onclick="step(-1)">&laquo; Prev</button>
 <button onclick="step(1)">Next &raquo;</button>
 <button onclick="loadSelected()">Load</button>
 <button onclick="setMode('pen')">Pen</button>
 <button onclick="setMode('eraser')">Eraser</button>
 size <input id="size" type="range" min="2" max="80" value="24">
 <button onclick="undo()">Undo</button>
 <button onclick="redo()">Redo</button>
 <button onclick="clearMask()">Clear</button>
 <button onclick="autoFill()">Auto-fill lanes</button>
 <button onclick="save()">Save mask</button>
 <button onclick="batchOp('delete_mask')">Delete mask</button>
 <button onclick="batchOp('dedupe')">Dedupe images</button>
</div>
<div id="wrap">
 <img id="photo">
 <canvas id="paint"></canvas>
</div>
<script>
let mode='pen', drawing=false, history=[], future=[], current=null;
const paint=document.getElementById('paint'), ctx=paint.getContext('2d');
function setMode(m){ mode=m; }
async function refresh(){
  const files=await (await fetch('/api/images')).json();
  const sel=document.getElementById('files');
  const keep=sel.value; sel.innerHTML='';
  for(const f of files){
    const o=document.createElement('option'); o.value=f.name;
    o.text=f.name + (f.has_mask?' [done]':''); sel.add(o);
  }
  if(keep) sel.value=keep;
}
function step(d){
  const sel=document.getElementById('files');
  const i=Math.min(Math.max(sel.selectedIndex+d,0), sel.length-1);
  sel.selectedIndex=i; loadSelected();
}
function drawOverlay(src){
  const m=new Image();
  m.onload=()=>{
    snapshot();  // strokes drawn before the overlay decoded stay undoable
    ctx.clearRect(0,0,paint.width,paint.height); ctx.drawImage(m,0,0);
    if(src.startsWith('blob:')) URL.revokeObjectURL(src);
  };
  m.src=src;
}
function loadSelected(){
  current=document.getElementById('files').value;
  const img=document.getElementById('photo');
  img.onload=async ()=>{ paint.width=img.naturalWidth; paint.height=img.naturalHeight;
    document.getElementById('wrap').style.width=img.naturalWidth+'px';
    document.getElementById('wrap').style.height=img.naturalHeight+'px';
    img.style.position='static'; ctx.clearRect(0,0,paint.width,paint.height);
    history=[]; future=[];
    const r=await fetch('/mask/'+current);
    if(r.ok) drawOverlay(URL.createObjectURL(await r.blob()));
  };
  img.src='/image/'+current;
}
function pos(e){
  const r=paint.getBoundingClientRect();
  const t=e.touches?e.touches[0]:e;
  return [t.clientX-r.left, t.clientY-r.top];
}
function stroke(e){
  if(!drawing) return;
  const [x,y]=pos(e);
  ctx.globalCompositeOperation = mode==='pen' ? 'source-over':'destination-out';
  ctx.fillStyle='red';
  ctx.beginPath(); ctx.arc(x,y,document.getElementById('size').value/2,0,7); ctx.fill();
  e.preventDefault();
}
function snapshot(){
  history.push(ctx.getImageData(0,0,paint.width,paint.height)); future=[];
}
for(const ev of ['pointerdown']) paint.addEventListener(ev, e=>{
  snapshot(); drawing=true; stroke(e);});
for(const ev of ['pointermove']) paint.addEventListener(ev, stroke);
for(const ev of ['pointerup','pointerleave']) paint.addEventListener(ev, ()=>drawing=false);
function undo(){ if(history.length){
  future.push(ctx.getImageData(0,0,paint.width,paint.height));
  ctx.putImageData(history.pop(),0,0); } }
function redo(){ if(future.length){
  history.push(ctx.getImageData(0,0,paint.width,paint.height));
  ctx.putImageData(future.pop(),0,0); } }
function clearMask(){ snapshot(); ctx.clearRect(0,0,paint.width,paint.height); }
async function autoFill(){
  if(!current) return; snapshot();
  const r=await fetch('/api/auto_fill',{method:'POST',body:JSON.stringify(
    {mask_png_base64:paint.toDataURL('image/png').split(',')[1]})});
  const j=await r.json();
  if(j.overlay_png_base64) drawOverlay('data:image/png;base64,'+j.overlay_png_base64);
  document.getElementById('status').innerText=j.status||'';
}
async function save(){
  if(!current) return;
  const r=await fetch('/api/save_mask',{method:'POST',body:JSON.stringify(
    {name:current, mask_png_base64:paint.toDataURL('image/png').split(',')[1]})});
  document.getElementById('status').innerText=(await r.json()).status;
  refresh();
}
async function batchOp(op){
  const r=await fetch('/api/batch',{method:'POST',body:JSON.stringify(
    {op:op, name:current})});
  document.getElementById('status').innerText=(await r.json()).status;
  refresh();
  if(op==='delete_mask' && current) loadSelected();
}
refresh();
</script></body></html>
"""


def save_mask_from_base64(png_b64: str, out_path: str) -> int:
    """Decode the painted RGBA canvas → binary (0/255) mask PNG. Any pixel
    with alpha > 0 counts as foreground. Returns foreground pixel count."""
    raw = base64.b64decode(png_b64)
    alpha = image_io.decode_bytes(raw, "RGBA")[0][:, :, 3]
    mask = np.where(alpha > 0, 255, 0).astype(np.uint8)
    image_io.write_png(out_path, mask)
    return int((mask > 0).sum())


def mask_to_overlay_png_bytes(mask: np.ndarray) -> bytes:
    """Binary mask → red RGBA overlay PNG bytes the canvas can draw."""
    h, w = mask.shape
    rgba = np.zeros((h, w, 4), np.uint8)
    fg = mask > 0
    rgba[fg, 0] = 255
    rgba[fg, 3] = 255
    bio = io.BytesIO()
    image_io.write_png(bio, rgba)
    return bio.getvalue()


def mask_to_overlay_png_b64(mask: np.ndarray) -> str:
    return base64.b64encode(mask_to_overlay_png_bytes(mask)).decode()


def auto_fill_from_base64(png_b64: str, dilate_iterations: int = 2) -> tuple[str, int]:
    """Painted lane-line canvas → filled drivable-region overlay.

    Returns (overlay_png_base64, filled_pixel_count). Mirrors the
    reference's auto region fill between lane lines
    (reference:improved_web_annotation.py:1-12 via
    reference:convert_lane_to_drivable.py)."""
    raw = base64.b64decode(png_b64)
    alpha = image_io.decode_bytes(raw, "RGBA")[0][:, :, 3]
    lane = np.where(alpha > 0, 255, 0).astype(np.uint8)
    filled = convert_lane_to_drivable_mask(lane, dilate_iterations=dilate_iterations)
    return mask_to_overlay_png_b64(filled), int((filled > 0).sum())


class AnnotationServer:
    def __init__(self, images_dir: str, masks_dir: str, host="0.0.0.0", port=8080):
        self.images_dir = images_dir
        self.masks_dir = masks_dir
        self.host = host
        self.port = port
        os.makedirs(masks_dir, exist_ok=True)
        self.httpd = None
        self._thread = None

    def _handler(server_self):
        images_dir, masks_dir = server_self.images_dir, server_self.masks_dir

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, data, ctype, code=200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, obj, code=200):
                self._send(json.dumps(obj).encode(), "application/json", code)

            def do_GET(self):
                try:
                    self._do_get()
                except Exception as e:  # corrupt file etc. → 400, not a dropped socket
                    try:
                        self._send_json({"status": f"error: {e}"}, 400)
                    except Exception:
                        pass

            def _do_get(self):
                if self.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif self.path == "/api/images":
                    files = []
                    for f in sorted(os.listdir(images_dir)):
                        if f.lower().endswith((".jpg", ".jpeg", ".png")):
                            base = os.path.splitext(f)[0]
                            files.append(
                                {
                                    "name": f,
                                    "has_mask": os.path.exists(
                                        os.path.join(masks_dir, base + ".png")
                                    ),
                                }
                            )
                    self._send_json(files)
                elif self.path.startswith("/image/"):
                    name = os.path.basename(self.path[len("/image/") :])
                    path = os.path.join(images_dir, name)
                    if os.path.exists(path):
                        ctype = "image/png" if name.endswith(".png") else "image/jpeg"
                        with open(path, "rb") as f:
                            self._send(f.read(), ctype)
                    else:
                        self._send_json({}, 404)
                elif self.path.startswith("/mask/"):
                    name = os.path.basename(self.path[len("/mask/") :])
                    base = os.path.splitext(name)[0]
                    path = os.path.join(masks_dir, base + ".png")
                    if os.path.exists(path):
                        mask = image_io.read_image(path, "L")
                        self._send(mask_to_overlay_png_bytes(mask), "image/png")
                    else:
                        self._send_json({}, 404)
                else:
                    self._send_json({}, 404)

            def do_POST(self):
                try:
                    self._do_post()
                except Exception as e:  # malformed payload → 400, not a dropped socket
                    try:
                        self._send_json({"status": f"error: {e}"}, 400)
                    except Exception:
                        pass

            def _do_post(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                payload = json.loads(self.rfile.read(length)) if length else {}
                if self.path == "/api/save_mask":
                    name = os.path.basename(payload["name"])
                    base = os.path.splitext(name)[0]
                    out = os.path.join(masks_dir, base + ".png")
                    n = save_mask_from_base64(payload["mask_png_base64"], out)
                    self._send_json({"status": f"saved {base}.png ({n} px)"})
                elif self.path == "/api/auto_fill":
                    overlay, n = auto_fill_from_base64(
                        payload["mask_png_base64"],
                        dilate_iterations=int(payload.get("dilate", 2)),
                    )
                    self._send_json(
                        {"overlay_png_base64": overlay, "status": f"filled {n} px"}
                    )
                elif self.path == "/api/batch":
                    op = payload.get("op")
                    if op == "dedupe":
                        dups = dedupe_images(images_dir, delete=True)
                        total = sum(len(v) for v in dups.values())
                        # keep annotation work: remap a deleted duplicate's
                        # mask onto the kept image (or drop it if the kept
                        # image already has one)
                        remapped = 0
                        for kept, removed in dups.items():
                            kept_mask = os.path.join(
                                masks_dir,
                                os.path.splitext(os.path.basename(kept))[0] + ".png",
                            )
                            for dup in removed:
                                dup_mask = os.path.join(
                                    masks_dir,
                                    os.path.splitext(os.path.basename(dup))[0] + ".png",
                                )
                                if not os.path.exists(dup_mask):
                                    continue
                                if os.path.exists(kept_mask):
                                    os.remove(dup_mask)
                                else:
                                    os.rename(dup_mask, kept_mask)
                                    remapped += 1
                        self._send_json(
                            {
                                "status": f"deleted {total} duplicate images"
                                + (f", remapped {remapped} masks" if remapped else "")
                            }
                        )
                    elif op == "delete_mask":
                        name = os.path.basename(payload.get("name") or "")
                        base = os.path.splitext(name)[0]
                        path = os.path.join(masks_dir, base + ".png")
                        if base and os.path.exists(path):
                            os.remove(path)
                            self._send_json({"status": f"deleted {base}.png"})
                        else:
                            self._send_json({"status": "no mask to delete"})
                    elif op == "lane2drivable_all":
                        n = 0
                        for f in sorted(os.listdir(masks_dir)):
                            if not f.lower().endswith(".png"):
                                continue
                            path = os.path.join(masks_dir, f)
                            mask = image_io.read_image(path, "L")
                            image_io.write_png(path, convert_lane_to_drivable_mask(mask))
                            n += 1
                        self._send_json({"status": f"converted {n} masks"})
                    else:
                        self._send_json({"status": f"unknown op {op!r}"}, 400)
                else:
                    self._send_json({}, 404)

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
    parser = argparse.ArgumentParser(description="web annotation server")
    parser.add_argument("--images-dir", required=True)
    parser.add_argument("--masks-dir", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args(argv)
    server = AnnotationServer(args.images_dir, args.masks_dir, args.host, args.port)
    port = server.start()
    print(f"annotation server at http://{args.host}:{port}/ (Ctrl-C to stop)")
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
