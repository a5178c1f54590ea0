"""The port's host tools and their image conversions against the JAX
package's tools (and Pillow), on the same synthetic trees.

- ``image_io``'s ``convert='L'`` and ``'RGBA'``: bit for bit against
  Pillow 12.1.0 on hypothesis draws of L, RGB, P and RGBA PNGs, with and
  without a ``tRNS`` chunk;
- every tool (``dataset_tools``, ``dataset_check``, ``mask_editor``,
  ``calibration_tools``, ``annotation_server``) against the JAX tool on
  one synthetic tree of PNGs: each output file decoded equal to the JAX
  tool's (Pillow's zlib stream differs from the port's, so the files'
  bytes are not compared), each report and reply equal. The port runs
  with PIL and OpenCV blocked; the JAX tools run with OpenCV blocked
  (``convert_lane_to_drivable_mask`` takes its 4-neighbour branch, and
  the perception modules their numpy warps: ROADMAP.md, queue 3,
  not-faults 13 and 14);
- ``validate_predictions`` on shared weights: the report's per-image and
  ``OVERALL`` lines and the panels equal to the JAX tool's (both bf16; on
  these weights and images no pixel is a near-tie);
- ``get_fast_scnn``: the same refusal, and a ``pretrained`` load equal
  to the JAX factory's trees.
"""

import base64
import contextlib
import io
import json
import os
import shutil
import sys
import urllib.error
import urllib.request
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fastscnn_tpu.models.registry import get_fast_scnn as jax_get_fast_scnn
from fastscnn_tpu.perception import transform as jax_transform
from fastscnn_tpu.tools import annotation_server as jax_annotation
from fastscnn_tpu.tools import calibration_tools as jax_calibration
from fastscnn_tpu.tools import dataset_check as jax_check
from fastscnn_tpu.tools import dataset_tools as jax_tools
from fastscnn_tpu.tools import mask_editor as jax_editor
from fastscnn_tpu.tools import validate_predictions as jax_validate
from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.models import get_fast_scnn, to_param_trees
from fastscnn_tpu_torch.tools import annotation_server, calibration_tools, dataset_check
from fastscnn_tpu_torch.tools import dataset_tools, mask_editor, validate_predictions

Image.init()  # every PIL plugin loaded now: the JAX tools then import nothing of PIL later


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_cv2(monkeypatch):
    """Neither package reaches OpenCV: the JAX tools take their branches
    without it, as the port always does."""
    monkeypatch.setattr(jax_transform, "_HAS_CV2", False)
    monkeypatch.setitem(sys.modules, "cv2", None)


@contextlib.contextmanager
def pil_blocked():
    """The card's machine has no PIL: the port's calls run without it."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        sys.modules["PIL"] = saved


def decoded(path):
    return np.asarray(Image.open(path))


# --- image_io: 'L' and 'RGBA' as Pillow converts --------------------------------------


def _png_with(mode, arr, palette, trns):
    """An 8-bit PNG of ``arr`` in ``mode``, with a tRNS chunk where ``trns``
    is given: Pillow's file for L, RGB and RGBA (``transparency``); for P
    the port's writer (Pillow would pack a small palette's indices into
    fewer bits) and a tRNS chunk of one alpha per palette entry (an int:
    alpha 0 at that index, 255 before it, as Pillow writes one)."""
    bio = io.BytesIO()
    if mode != "P":
        Image.fromarray(arr, mode).save(bio, "PNG", **({} if trns is None
                                                        else {"transparency": trns}))
        return bio.getvalue()
    image_io.write_png(bio, arr, palette=palette)
    data = bio.getvalue()
    if trns is None:
        return data
    body = bytes([255] * trns + [0]) if isinstance(trns, int) else trns
    at = data.index(b"IDAT") - 4
    return data[:at] + image_io._chunk(b"tRNS", body) + data[at:]


@st.composite
def png_draws(draw):
    mode = draw(st.sampled_from(["L", "RGB", "P", "RGBA"]))
    h, w = draw(st.integers(1, 23)), draw(st.integers(1, 23))
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    palette, trns = None, None
    if mode == "P":
        entries = draw(st.integers(1, 256))
        palette = rng.integers(0, 256, 3 * entries).tolist()
        arr = rng.integers(0, min(entries + 3, 256), (h, w), dtype=np.uint8)  # some past the palette
        kind = draw(st.sampled_from(["none", "index", "bytes"]))
        if kind == "index":
            trns = int(rng.integers(0, entries))
        elif kind == "bytes":
            trns = bytes(rng.integers(0, 256, int(rng.integers(1, entries + 1))).tolist())
    else:
        arr = rng.integers(0, 4, (h, w) if mode == "L" else (h, w, len(mode)), dtype=np.uint8)
        arr = (arr * 85).astype(np.uint8)  # few values: a tRNS key matches some pixels
        if mode != "RGBA" and draw(st.booleans()):
            trns = 170 if mode == "L" else (170, 0, 255)
    return mode, arr, palette, trns


@settings(max_examples=120, deadline=None, database=None)
@given(draw=png_draws())
def test_l_and_rgba_conversions_equal_pillow(draw):
    mode, arr, palette, trns = draw
    data = _png_with(mode, arr, palette, trns)
    for convert in ("L", "RGBA", "RGB", None):
        with warnings.catch_warnings():  # Pillow warns on a P image's alphas kept as bytes
            warnings.simplefilter("ignore")
            img = Image.open(io.BytesIO(data))
            ref = np.asarray(img.convert(convert) if convert else img)
        with pil_blocked():
            got, got_mode = image_io.decode_bytes(data, convert)
        assert got_mode == (convert or mode)
        assert got.dtype == np.uint8 and got.shape == ref.shape, (mode, convert)
        np.testing.assert_array_equal(got, ref, err_msg=f"{mode} -> {convert}, tRNS {trns!r}")


def test_rgba_pngs_write_and_sizes_read_from_headers(tmp_path):
    """``write_png`` of (H, W, 4) reads back in Pillow; ``image_size`` reads
    a PNG's and a JPEG's (baseline and progressive) without PIL, and so do
    a JPEG's pixels and a JPEG write (Pillow's pixels and bytes); a BMP
    write still raises without PIL, naming the item of the formats only
    PIL reads."""
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, (7, 9, 4), dtype=np.uint8)
    image_io.write_png(str(tmp_path / "a.png"), rgba)
    np.testing.assert_array_equal(decoded(tmp_path / "a.png"), rgba)
    for name, kw in (("b.jpg", {}), ("c.jpg", {"progressive": True}), ("d.jpeg", {"quality": 30})):
        Image.fromarray(rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)).save(tmp_path / name,
                                                                                 **kw)
    Image.fromarray(rgba[..., :3]).save(tmp_path / "ref.jpg")
    with pil_blocked():
        assert image_io.image_size(str(tmp_path / "a.png")) == (9, 7)
        for name in ("b.jpg", "c.jpg", "d.jpeg"):
            assert image_io.image_size(str(tmp_path / name)) == Image.open(tmp_path / name).size
        pixels = {name: image_io.read_image(str(tmp_path / name)) for name in ("b.jpg", "c.jpg")}
        image_io.save_image(str(tmp_path / "e.jpg"), rgba[..., :3])
        with pytest.raises(RuntimeError, match="f.bmp.*item 10: formats only PIL reads"):
            image_io.save_image(str(tmp_path / "f.bmp"), rgba[..., :3])
    for name, arr in pixels.items():
        np.testing.assert_array_equal(arr, decoded(tmp_path / name))
    assert (tmp_path / "e.jpg").read_bytes() == (tmp_path / "ref.jpg").read_bytes()


# --- one synthetic tree for the tools ---------------------------------------------------


H, W = 36, 64


def _lane_mask(rng, h=H, w=W):
    """Two broken lane lines (gaps the dilation bridges), 0/255."""
    m = np.zeros((h, w), np.uint8)
    left, right = int(rng.integers(4, 20)), int(rng.integers(40, 60))
    for y in range(h):
        if rng.random() < 0.8:
            m[y, left + y // 8] = 255
        if rng.random() < 0.8:
            m[y, right - y // 8] = 255
    return m


@pytest.fixture()
def tree(tmp_path):
    """images/*.png (RGB; one byte-identical duplicate), masks/*.png (L lane
    lines; one at half size, one palette mask, one missing), written by
    Pillow as a user's tree would be (but the palette mask)."""
    rng = np.random.default_rng(5)
    root = tmp_path / "tree"
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            root / "images" / f"f{i}.png")
        if i == 5:
            continue  # an image without a mask
        mask = _lane_mask(rng)
        if i == 2:  # half size: dataset_check reports it, the editor resizes it
            Image.fromarray(mask[::2, ::2]).save(root / "masks" / f"f{i}.png")
        elif i == 3:  # an 8-bit palette mask of class ids 0..2 (Pillow packs so small a
            # palette's indices into 2 bits, a PNG the port leaves to PIL)
            image_io.write_png(str(root / "masks" / f"f{i}.png"), (mask // 127).astype(np.uint8),
                               palette=[0, 0, 0, 255, 0, 0, 0, 255, 0])
        else:
            Image.fromarray(mask).save(root / "masks" / f"f{i}.png")
    shutil.copy(root / "images" / "f1.png", root / "images" / "f1_dup.png")
    return root


def _twin(tree, tmp_path):
    """Two copies of ``tree``: the JAX tool's and the port's."""
    a, b = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(tree, a)
    shutil.copytree(tree, b)
    return a, b


def assert_same_files(a, b):
    """The same file names under both roots, each PNG decoded equal."""
    names_a = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    names_b = sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    assert names_a == names_b
    for name in names_a:
        if name.endswith(".png"):
            ia, ib = Image.open(a / name), Image.open(b / name)
            assert ia.mode == ib.mode, name
            np.testing.assert_array_equal(np.asarray(ib), np.asarray(ia), err_msg=name)
        elif name.endswith(".json"):
            assert json.loads((a / name).read_text()) == json.loads((b / name).read_text()), name


def _both(capsys, jax_main, port_main, argv_of):
    """Run the JAX CLI, then the port's with PIL blocked; return both stdouts."""
    jax_main(argv_of("jax"))
    out_jax = capsys.readouterr().out
    with pil_blocked():
        port_main(argv_of("port"))
    return out_jax, capsys.readouterr().out


def test_dataset_tools_cli_matches_jax(tree, tmp_path, capsys):
    a, b = _twin(tree, tmp_path)
    roots = {"jax": a, "port": b}
    for argv in (
        lambda k: ["augment", "--images", str(roots[k] / "images"), "--masks",
                   str(roots[k] / "masks")],
        lambda k: ["lane2drivable", "--input-dir", str(roots[k] / "masks"), "--output-dir",
                   str(roots[k] / "drivable")],
        lambda k: ["lane2drivable", "--input-dir", str(roots[k] / "masks"), "--output-dir",
                   str(roots[k] / "drivable0"), "--dilate", "0"],
        lambda k: ["dedupe", "--dir", str(roots[k] / "images")],
        lambda k: ["dedupe", "--dir", str(roots[k] / "images"), "--delete"],
    ):
        out_jax, out_port = _both(capsys, jax_tools.main, dataset_tools.main, argv)
        assert out_port == out_jax
    assert (b / "images" / "f0_flipped.png").exists() and (b / "masks" / "f4_flipped.png").exists()
    assert not (b / "images" / "f1_dup.png").exists()
    assert_same_files(a, b)
    # the palette mask kept its palette through the flip
    assert Image.open(b / "masks" / "f3_flipped.png").mode == "P"


def test_dataset_check_matches_jax(tree, tmp_path, capsys):
    """The masks report (a size mismatch read from a JPEG's header too)
    and the overlay grid (a nearest-resized mask, a bilinear-resized tile)."""
    a, b = _twin(tree, tmp_path)
    for root in (a, b):  # an image of another size for the grid's bilinear tile
        Image.fromarray(np.full((18, 32, 3), 90, np.uint8)).save(root / "images" / "f4.png")
    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(a / "images" / "g.jpg")
    shutil.copy(a / "images" / "g.jpg", b / "images" / "g.jpg")
    for root in (a, b):
        Image.fromarray(np.zeros((H, W), np.uint8)).save(root / "masks" / "g.png")
    ref = jax_check.check_masks(str(a / "images"), str(a / "masks"))
    with pil_blocked():
        got = dataset_check.check_masks(str(b / "images"), str(b / "masks"))
    assert got == ref
    assert any("size mismatch" in i for r in got for i in r["issues"])
    os.remove(a / "masks" / "g.png")
    os.remove(b / "masks" / "g.png")
    roots = {"jax": a, "port": b}
    for argv in (lambda k: ["masks", "--images-dir", str(roots[k] / "images"), "--masks-dir",
                            str(roots[k] / "masks")],
                 lambda k: ["overlay", "--images-dir", str(roots[k] / "images"), "--masks-dir",
                            str(roots[k] / "masks"), "--out", str(roots[k] / "grid.png")]):
        out_jax, out_port = _both(capsys, jax_check.main, dataset_check.main, argv)
        assert out_port == out_jax.replace(str(a), str(b))
    np.testing.assert_array_equal(decoded(b / "grid.png"), decoded(a / "grid.png"))


def test_mask_editor_session_matches_jax(tree, tmp_path):
    a, b = _twin(tree, tmp_path)
    ja = jax_editor.EditorSession(str(a / "images"), str(a / "masks"))
    with pil_blocked():
        pb = mask_editor.EditorSession(str(b / "images"), str(b / "masks"))

    def same():
        assert [os.path.basename(p) for p in pb.image_files] == [
            os.path.basename(p) for p in ja.image_files]
        assert pb.index == ja.index
        np.testing.assert_array_equal(pb.image, ja.image)
        np.testing.assert_array_equal(pb.canvas.mask, ja.canvas.mask)
        np.testing.assert_array_equal(pb.overlay(), ja.overlay())

    same()
    for _ in range(3):  # onto f2, whose half-size mask is resized (nearest)
        assert ja.next()
        with pil_blocked():
            assert pb.next()
        same()
    for s in (ja, pb):
        s.canvas.rectangle(40, 30, 5, 2)
        s.canvas.brush(20, 10, 4)
        s.canvas.polygon([(0, 0), (30, 5), (10, 30)])
        s.canvas.flood_fill(60, 30, 128)
        s.canvas.undo()
    ja.save()
    with pil_blocked():
        pb.save()
        assert pb.prev()
    assert ja.prev()
    same()
    assert_same_files(a, b)
    with pytest.raises(NotImplementedError, match="item 5, left out: display windows"):
        mask_editor.main(["--image", str(b / "images" / "f0.png")])
    with pytest.raises(NotImplementedError, match="display windows"):
        mask_editor.main(["--images-dir", str(b / "images")])


def test_calibration_tools_match_jax(tree, tmp_path, capsys):
    a, b = _twin(tree, tmp_path)
    points = [(260, 87), (378, 87), (410, 217), (231, 221)]
    ref = jax_calibration.calibrate_from_points(points, 20.0, 30.0, (64, 36))
    got = calibration_tools.calibrate_from_points(points, 20.0, 30.0, (64, 36))
    assert got.keys() == ref.keys()
    for key in ref:
        if "matrix" in key:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, atol=1e-12)
        else:
            assert got[key] == ref[key], key
    roots = {"jax": a, "port": b}
    for argv in (
        lambda k: ["from-points", "--points", "20,10", "44,10", "60,30", "4,30", "--image-width",
                   "64", "--image-height", "36", "--out", str(roots[k] / "cal.json")],
        lambda k: ["batch-bev", "--input-dir", str(roots[k] / "images"), "--output-dir",
                   str(roots[k] / "bev"), "--masks-dir", str(roots[k] / "masks"),
                   "--calibration", str(roots[k] / "cal.json"), "--pixels-per-unit", "2"],
    ):
        out_jax, out_port = _both(capsys, jax_calibration.main, calibration_tools.main, argv)
        assert out_port == out_jax.replace(str(a), str(b))
    cal_a, cal_b = (json.loads((r / "cal.json").read_text()) for r in (a, b))
    np.testing.assert_allclose(cal_b["transform_matrix"], cal_a["transform_matrix"], rtol=1e-12)
    (a / "cal.json").unlink()
    (b / "cal.json").unlink()
    assert_same_files(a, b)
    with pil_blocked(), pytest.raises(NotImplementedError, match="display windows"):
        calibration_tools.main(["pick", "--image", str(b / "images" / "f0.png")])


# --- the annotation server over HTTP --------------------------------------------------


def _canvas_b64(rgba):
    """A painted canvas as the page sends it: Pillow's RGBA PNG, base64."""
    bio = io.BytesIO()
    Image.fromarray(rgba).save(bio, "PNG")
    return base64.b64encode(bio.getvalue()).decode()


def _session(server_cls, images, masks, block):
    """Every route of the page, in the page's order of use; returns the
    replies, each decoded (PNG bodies to arrays)."""
    server = server_cls(str(images), str(masks), host="127.0.0.1", port=0)
    with block():
        port = server.start()
    base = f"http://127.0.0.1:{port}"
    canvas = np.zeros((H, W, 4), np.uint8)
    canvas[:, 10, 3] = 255
    canvas[:, 50, 3] = 200
    canvas[5:9, 20:30] = [255, 0, 0, 90]
    lanes = np.zeros((H, W, 4), np.uint8)
    lanes[:, 6, 3] = 255
    lanes[::3, 40, 3] = 255
    b64, lanes_b64 = _canvas_b64(canvas), _canvas_b64(lanes)

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read()

    def post(path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    replies = []
    try:
        with block():  # PNG bodies stay bytes in here: Pillow decodes them afterwards
            status, ctype, page = get("/")
            replies.append((status, ctype, len(page) > 1000))
            replies.append(json.loads(get("/api/images")[2]))
            status, ctype, body = get("/image/f0.png")
            replies.append((status, ctype, body == (images / "f0.png").read_bytes()))
            for name in ("f0.png", "f3.png", "f5.png"):  # an L mask, a palette mask, none
                replies.append(get("/mask/" + name))
            replies.append(post("/api/save_mask", {"name": "f5.png", "mask_png_base64": b64}))
            replies.append(json.loads(get("/api/images")[2]))
            for dilate in (2, 0):
                status, reply = post("/api/auto_fill", {"mask_png_base64": lanes_b64,
                                                        "dilate": dilate})
                overlay = base64.b64decode(reply.pop("overlay_png_base64"))
                replies.append((status, reply, overlay))
            replies.append(post("/api/batch", {"op": "delete_mask", "name": "f0.png"}))
            replies.append(post("/api/batch", {"op": "delete_mask", "name": "f0.png"}))
            replies.append(post("/api/batch", {"op": "dedupe"}))
            replies.append(post("/api/batch", {"op": "lane2drivable_all"}))
            replies.append(post("/api/batch", {"op": "nope"}))
            replies.append(post("/api/save_mask", {"name": "x.png", "mask_png_base64": "!!"})[0])
            replies.append(get("/nowhere")[0])
    finally:
        server.stop()
    for i in (3, 4, 5):  # the masks' overlays
        status, ctype, body = replies[i]
        replies[i] = (status, ctype, decoded(io.BytesIO(body)) if status == 200 else body)
    for i in (8, 9):  # the auto-fill overlays
        status, reply, body = replies[i]
        replies[i] = (status, reply, decoded(io.BytesIO(body)))
    return replies


def assert_same_replies(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if isinstance(r, tuple):
            assert len(g) == len(r), i
            for gg, rr in zip(g, r):
                if isinstance(rr, np.ndarray):
                    np.testing.assert_array_equal(gg, rr, err_msg=f"reply {i}")
                else:
                    assert gg == rr, (i, gg, rr)
        else:
            assert g == r, (i, g, r)


def test_annotation_server_matches_jax(tree, tmp_path):
    """Both servers on 127.0.0.1, driven through every route: the same
    replies (PNG bodies decoded), then the same trees on disk."""
    a, b = _twin(tree, tmp_path)
    shutil.copy(a / "images" / "f1.png", a / "images" / "f2_dup.png")  # a duplicate that has
    shutil.copy(b / "images" / "f1.png", b / "images" / "f2_dup.png")  # a mask to remap
    for root in (a, b):
        shutil.copy(root / "masks" / "f4.png", root / "masks" / "f2_dup.png")
    ref = _session(jax_annotation.AnnotationServer, a / "images", a / "masks",
                   contextlib.nullcontext)
    got = _session(annotation_server.AnnotationServer, b / "images", b / "masks", pil_blocked)
    assert_same_replies(got, ref)
    assert "remapped" in ref[-5][1]["status"] or "deleted" in ref[-5][1]["status"]
    assert_same_files(a, b)


def test_annotation_helpers_match_jax():
    rng = np.random.default_rng(2)
    rgba = rng.integers(0, 256, (12, 17, 4), dtype=np.uint8)
    rgba[..., 3] *= rng.random((12, 17)) < 0.3
    b64 = _canvas_b64(rgba)
    ref_overlay, ref_n = jax_annotation.auto_fill_from_base64(b64, 1)
    with pil_blocked():
        overlay, n = annotation_server.auto_fill_from_base64(b64, 1)
        mask_png = annotation_server.mask_to_overlay_png_bytes(rgba[..., 0])
    assert n == ref_n
    np.testing.assert_array_equal(decoded(io.BytesIO(base64.b64decode(overlay))),
                                  decoded(io.BytesIO(base64.b64decode(ref_overlay))))
    np.testing.assert_array_equal(
        decoded(io.BytesIO(mask_png)),
        decoded(io.BytesIO(jax_annotation.mask_to_overlay_png_bytes(rgba[..., 0]))))


# --- validate_predictions and get_fast_scnn ---------------------------------------------


@pytest.fixture(scope="module")
def shared_weights(tmp_path_factory):
    """A 2-class ``fast_scnn_custom.pth`` (aux head included) from a JAX
    initialisation, written by the port's ``.pth`` writer."""
    from fastscnn_tpu.models import init_fast_scnn as jax_init
    from fastscnn_tpu_torch.utils.checkpoint import save_pth_checkpoint

    params, state = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(4), 2, aux=True))
    folder = tmp_path_factory.mktemp("weights")
    save_pth_checkpoint(params, state, str(folder), dataset="custom")
    return folder


def test_validate_predictions_matches_jax(tree, tmp_path, shared_weights, monkeypatch, capsys):
    a, b = _twin(tree, tmp_path)
    weights = str(shared_weights / "fast_scnn_custom.pth")
    monkeypatch.chdir(tmp_path)

    def argv(root):
        return ["--dataset", "custom", "--data-root", str(root), "--weights", weights,
                "--base-size", "48", "--crop-size", "32", "--max-images", "3",
                "--outdir", str(root / "vr")]

    ref = jax_validate.main(argv(a))
    with pil_blocked():
        got = validate_predictions.main(argv(b) + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("overall: pixAcc") == 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    assert (b / "vr" / "validation_report.csv").read_text() == (
        a / "vr" / "validation_report.csv").read_text()
    assert_same_files(a / "vr", b / "vr")
    with pil_blocked():
        validate_predictions.main(argv(b)[:4] + ["--max-images", "1", "--outdir",
                                                 str(b / "vr0"), "--device", "cpu"])
    assert "warning: random init" in capsys.readouterr().out
    assert (b / "vr0" / "val_0_panel.png").exists()


def test_get_fast_scnn_matches_jax(shared_weights):
    with pytest.raises(ValueError, match="num_classes="):
        jax_get_fast_scnn("cityscapes_fine")
    with pytest.raises(ValueError, match="num_classes="):
        get_fast_scnn("cityscapes_fine", device="cpu")
    assert get_fast_scnn("cityscapes_fine", num_classes=5, device="cpu").num_classes == 5
    for aux in (False, True):
        _, ref_p, ref_s = jax_get_fast_scnn("custom", pretrained=True, root=str(shared_weights),
                                            aux=aux)
        model = get_fast_scnn("custom", pretrained=True, root=str(shared_weights), aux=aux,
                              device="cpu")
        assert model.aux == aux and not model.training
        params, state = to_param_trees(model)
        if not aux:
            ref_p = {k: v for k, v in ref_p.items() if k != "auxlayer"}
            ref_s = {k: v for k, v in ref_s.items() if k != "auxlayer"}
        ref_leaves = jax.tree_util.tree_leaves((ref_p, ref_s))
        got_leaves = jax.tree_util.tree_leaves((params, state))
        assert len(got_leaves) == len(ref_leaves)
        for g, r in zip(got_leaves, ref_leaves):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(r))
    seeded = [get_fast_scnn("citys", seed=s, device="cpu").state_dict() for s in (3, 3, 4)]
    assert all(torch.equal(seeded[0][k], seeded[1][k]) for k in seeded[0])
    assert not all(torch.equal(seeded[0][k], seeded[2][k]) for k in seeded[0])
