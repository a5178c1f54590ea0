"""Self-contained ONNX emission + verification — no ``onnx`` package needed.

The port's own copy of ``fastscnn_tpu/engine/onnx_native.py``. The
reference's shipped deploy artifact is an ONNX file
(reference:export_onnx_fixed.py:308-318, opset 11 via ``torch.onnx.export``).
``torch.onnx`` needs the ``onnx`` package, which neither this package's
hosts nor the card's machine have, so the graph is emitted from first
principles:

* :func:`emit_fastscnn_onnx` — builds the Fast-SCNN end-to-end deploy graph
  (preprocessing → BN-folded backbone → resize/softmax/argmax postprocessing,
  mirroring ``InferenceEngine``'s graph and the reference's
  ``EndToEndFastSCNN`` wrapper, reference:export_onnx_fixed.py:34-98) directly
  as an ONNX ``ModelProto``, hand-encoding the protobuf wire format. The
  emitted graph is standard NCHW ONNX (opset 13) loadable by onnxruntime,
  Netron, ATC, or any other consumer; for the same weights it is the JAX
  package's graph node for node.
* :func:`parse_onnx` / :func:`run_onnx` — a minimal ModelProto parser and a
  numpy evaluator for the emitted op set, used as the post-export smoke/parity
  gate when onnxruntime is absent (the reference gates its export the same
  way with ORT, reference:export_onnx_fixed.py:382-443).

Design notes
------------

* The folded tree (``fold_inference_params(model, torch.float32)`` as numpy)
  holds HWIO weights, as the JAX package's does; ONNX ``Conv`` wants
  (M, C/g, kH, kW) — a (3, 2, 0, 1) transpose at emission. The artifact
  keeps the standard ONNX NCHW contract.
* Pyramid pooling: when the feature map divides the bin count exactly,
  adaptive pooling equals a fixed ``AveragePool`` (the reference's ATC trick,
  reference:export_onnx_fixed.py:106-118). When it does NOT divide (e.g. the
  flagship 1024×2048 input → 32×64 feature map with bins 1/2/3/6), the
  reference *changed the architecture* to pool sizes 1/2/4/8 and accepted
  0.38% deploy pixel drift; we instead emit the exact PyTorch bin-average as
  two ``MatMul`` contractions per branch (the same separable-matrix trick the
  serving path uses for resize), so the artifact preserves training
  semantics at ANY resolution.
* Resize: opset-13 ``Resize`` with ``coordinate_transformation_mode``
  'align_corners' (the network's internal upsamples,
  reference:models/fast_scnn.py:40) / 'half_pixel' (the E2E wrapper's
  in/out resizes, reference:export_onnx_fixed.py:62-78) / 'asymmetric' +
  ``nearest_mode='floor'`` (mask resize-back).
* Opset 13 rather than the reference's 11 for one reason: per-axis
  ``Softmax``. Opset-11 Softmax flattens to 2-D at the axis (normalizing
  over C·H·W for axis=1 on NCHW), which is why torch's opset-11 export of a
  4-D softmax needs transpose workarounds; every other op emitted here has
  identical semantics in 11 and 13.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace

import numpy as np

__all__ = [
    "emit_fastscnn_onnx",
    "parse_onnx",
    "run_onnx",
    "OnnxGraphBuilder",
    "OnnxArtifact",
    "folded_numpy",
]

# ---------------------------------------------------------------------------
# protobuf wire-format encoding (the subset ONNX needs)
# ---------------------------------------------------------------------------

_WIRE_VARINT, _WIRE_F64, _WIRE_LEN, _WIRE_F32 = 0, 1, 2, 5


def _varint(n: int) -> bytes:
    if n < 0:  # protobuf int64: negative encodes as 10-byte two's complement
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, _WIRE_VARINT) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, _WIRE_LEN) + _varint(len(value)) + value


def _f_str(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _f_float(field: int, value: float) -> bytes:
    return _key(field, _WIRE_F32) + struct.pack("<f", value)


def _f_packed_varints(field: int, values) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return _f_bytes(field, payload)


# ONNX TensorProto.DataType
_DT_FLOAT, _DT_UINT8, _DT_INT8, _DT_INT32, _DT_INT64, _DT_BOOL = 1, 2, 3, 6, 7, 9
_DT_FLOAT16, _DT_DOUBLE, _DT_BFLOAT16 = 10, 11, 16

_NP_TO_DT = {
    np.dtype(np.float32): _DT_FLOAT,
    np.dtype(np.uint8): _DT_UINT8,
    np.dtype(np.int8): _DT_INT8,
    np.dtype(np.int32): _DT_INT32,
    np.dtype(np.int64): _DT_INT64,
    np.dtype(np.bool_): _DT_BOOL,
    np.dtype(np.float16): _DT_FLOAT16,
    np.dtype(np.float64): _DT_DOUBLE,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}

# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR, _AT_FLOATS, _AT_INTS, _AT_STRINGS = (
    1, 2, 3, 4, 6, 7, 8,
)


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_DT[arr.dtype]
    body = _f_packed_varints(1, arr.shape)  # dims
    body += _f_varint(2, dt)  # data_type
    body += _f_str(8, name)  # name
    body += _f_bytes(9, arr.tobytes())  # raw_data (little-endian, as numpy)
    return body


def _attr(name: str, value) -> bytes:
    body = _f_str(1, name)
    if isinstance(value, float):
        body += _f_float(2, value) + _f_varint(20, _AT_FLOAT)
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        body += _f_varint(3, int(value)) + _f_varint(20, _AT_INT)
    elif isinstance(value, str):
        body += _f_bytes(4, value.encode("utf-8")) + _f_varint(20, _AT_STRING)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        body += _f_bytes(7, b"".join(struct.pack("<f", v) for v in value))
        body += _f_varint(20, _AT_FLOATS)
    elif isinstance(value, (list, tuple)):
        body += _f_packed_varints(8, value) + _f_varint(20, _AT_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return body


def _value_info(name: str, dtype: np.dtype, shape) -> bytes:
    dims = b"".join(
        _f_bytes(1, _f_varint(1, int(d)))  # Dimension.dim_value
        for d in shape
    )
    tensor_type = _f_varint(1, _NP_TO_DT[np.dtype(dtype)]) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


class OnnxGraphBuilder:
    """Accumulates nodes/initializers and serializes a ModelProto."""

    def __init__(self, name: str = "fastscnn"):
        self.name = name
        self._nodes: list[bytes] = []
        self._inits: list[bytes] = []
        self._inputs: list[bytes] = []
        self._outputs: list[bytes] = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def initializer(self, arr: np.ndarray, hint: str = "w") -> str:
        name = self.fresh(hint)
        self._inits.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def node(self, op_type: str, inputs, outputs=None, **attrs):
        if outputs is None:
            outputs = [self.fresh(op_type.lower())]
        body = b"".join(_f_str(1, i) for i in inputs)
        body += b"".join(_f_str(2, o) for o in outputs)
        body += _f_str(3, self.fresh(f"n_{op_type}"))
        body += _f_str(4, op_type)
        for k, v in attrs.items():
            body += _f_bytes(5, _attr(k, v))
        self._nodes.append(body)
        return outputs[0] if len(outputs) == 1 else outputs

    def graph_input(self, name: str, dtype, shape):
        self._inputs.append(_value_info(name, dtype, shape))

    def graph_output(self, name: str, dtype, shape):
        self._outputs.append(_value_info(name, dtype, shape))

    def serialize(self, opset: int = 13, producer: str = "fastscnn-tpu",
                  doc: str = "") -> bytes:
        graph = b"".join(_f_bytes(1, n) for n in self._nodes)
        graph += _f_str(2, self.name)
        graph += b"".join(_f_bytes(5, t) for t in self._inits)
        if doc:
            graph += _f_str(10, doc)
        graph += b"".join(_f_bytes(11, v) for v in self._inputs)
        graph += b"".join(_f_bytes(12, v) for v in self._outputs)

        opset_id = _f_str(1, "") + _f_varint(2, opset)
        model = _f_varint(1, 7)  # ir_version 7 (ONNX 1.8, opset-13 era)
        model += _f_str(2, producer)
        model += _f_str(3, "1.0")
        model += _f_bytes(7, graph)
        model += _f_bytes(8, opset_id)
        return model


# ---------------------------------------------------------------------------
# Fast-SCNN deploy-graph emission
# ---------------------------------------------------------------------------


def _np_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def folded_numpy(model):
    """The emitter's ``folded_params`` for a port ``FastSCNN``: its
    BN-folded HWIO tree in f32 (``fold_inference_params``), as numpy."""
    import torch

    from fastscnn_tpu_torch.models.fast_scnn import fold_inference_params
    from fastscnn_tpu_torch.utils.tree import tree_map

    with torch.no_grad():
        folded = fold_inference_params(model, dtype=torch.float32)
    return tree_map(lambda t: t.detach().cpu().numpy(), folded)


def _conv_w(p) -> np.ndarray:
    """HWIO → ONNX (M, C/g, kH, kW)."""
    return _np_f32(p["w"]).transpose(3, 2, 0, 1)


def _adaptive_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bin-average matrix with PyTorch adaptive bins
    (bin i = [floor(i*in/out), ceil((i+1)*in/out)) — ops/pool.py)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        stop = -((-(i + 1) * in_size) // out_size)
        m[i, start:stop] = 1.0 / (stop - start)
    return m


def _resize_inputs(b: OnnxGraphBuilder, x: str, sizes) -> list[str]:
    """Resize op inputs: X, roi (omitted), scales (omitted), sizes."""
    size_init = b.initializer(np.asarray(sizes, dtype=np.int64), "sizes")
    return [x, "", "", size_init]


class _Emitter:
    """Walks the folded parameter tree exactly like
    ``FastSCNN.apply_folded`` (``models/fast_scnn.py``), emitting NCHW
    ONNX nodes. Spatial shapes are tracked statically (the artifact is
    fixed-shape, like the reference's ATC-compiled OM)."""

    def __init__(self, b: OnnxGraphBuilder, ppm_sizes, ppm_align_corners, batch: int):
        self.b = b
        self.ppm_sizes = tuple(ppm_sizes)
        self.ppm_align_corners = bool(ppm_align_corners)
        self.batch = int(batch)

    # -- primitives --------------------------------------------------------
    def conv(self, p, x: str, hw, stride=1, padding=0, groups=1, relu=True):
        b = self.b
        w = _conv_w(p)
        kh, kw = w.shape[2], w.shape[3]
        w_name = b.initializer(w, "W")
        bias = b.initializer(_np_f32(p["b"]), "B")
        y = b.node(
            "Conv", [x, w_name, bias],
            strides=[stride, stride], pads=[padding, padding, padding, padding],
            group=groups, kernel_shape=[kh, kw], dilations=[1, 1],
        )
        if relu:
            y = b.node("Relu", [y])
        out_hw = tuple((s + 2 * padding - k) // stride + 1
                       for s, k in zip(hw, (kh, kw)))
        return y, out_hw

    def ds(self, p, x, hw, stride=1, channels=None):
        y, hw = self.conv(p["dw"], x, hw, stride=stride, padding=1, groups=channels)
        y, hw = self.conv(p["pw"], y, hw)
        return y, hw

    def bottleneck(self, p, x, hw, stride, cin):
        z, hw2 = self.conv(p["expand"], x, hw)
        cmid = _conv_w(p["expand"]).shape[0]
        z, hw2 = self.conv(p["dw"], z, hw2, stride=stride, padding=1, groups=cmid)
        z, hw2 = self.conv(p["project"], z, hw2, relu=False)
        cout = _conv_w(p["project"]).shape[0]
        if stride == 1 and cin == cout:
            z = self.b.node("Add", [x, z])
        return z, hw2, cout

    def resize_linear(self, x, hw, out_hw, align_corners: bool, channels: int):
        if tuple(hw) == tuple(out_hw):
            return x, tuple(out_hw)
        mode = "align_corners" if align_corners else "half_pixel"
        y = self.b.node(
            "Resize",
            _resize_inputs(self.b, x, (self.batch, int(channels)) + tuple(out_hw)),
            mode="linear", coordinate_transformation_mode=mode,
        )
        return y, tuple(out_hw)

    def adaptive_pool(self, x, hw, n: int):
        """Adaptive avg-pool to (n, n): AveragePool when bins divide
        exactly, else the exact separable MatMul formulation."""
        b = self.b
        h, w = hw
        if h % n == 0 and w % n == 0:
            y = b.node(
                "AveragePool", [x], kernel_shape=[h // n, w // n],
                strides=[h // n, w // n],
            )
            return y, (n, n)
        # exact PyTorch bins: A_h (n,h) @ X (N,C,h,w) → (N,C,n,w), then
        # (N,C,n,w) @ A_w^T (w,n) → (N,C,n,n). numpy-matmul broadcasting.
        a_h = b.initializer(_adaptive_matrix(h, n), "poolA")
        y = b.node("MatMul", [a_h, x])
        a_wt = b.initializer(_adaptive_matrix(w, n).T.copy(), "poolB")
        y = b.node("MatMul", [y, a_wt])
        return y, (n, n)

    # -- the backbone --------------------------------------------------------
    def backbone(self, fparams, x, hw, num_classes, aux=False):
        p = fparams
        ltd = p["learning_to_downsample"]
        y, hw = self.conv(ltd["conv"], x, hw, stride=2)
        y, hw = self.ds(ltd["dsconv1"], y, hw, stride=2,
                        channels=_conv_w(ltd["dsconv1"]["dw"]).shape[0])
        higher, hw8 = self.ds(ltd["dsconv2"], y, hw, stride=2,
                              channels=_conv_w(ltd["dsconv2"]["dw"]).shape[0])
        higher_c = _conv_w(ltd["dsconv2"]["pw"]).shape[0]

        g = p["global_feature_extractor"]
        y, hw_g, c = higher, hw8, higher_c
        for name, stride in (("bottleneck1", 2), ("bottleneck2", 2), ("bottleneck3", 1)):
            for i, bp in enumerate(g[name]):
                y, hw_g, c = self.bottleneck(bp, y, hw_g, stride if i == 0 else 1, c)

        feats = [y]
        for conv_name, pool_size in zip(("conv1", "conv2", "conv3", "conv4"),
                                        self.ppm_sizes):
            z, phw = self.adaptive_pool(y, hw_g, pool_size)
            z, phw = self.conv(g["ppm"][conv_name], z, phw)
            z, _ = self.resize_linear(
                z, phw, hw_g, self.ppm_align_corners,
                channels=_conv_w(g["ppm"][conv_name]).shape[0],
            )
            feats.append(z)
        y = self.b.node("Concat", feats, axis=1)
        lower, _ = self.conv(g["ppm"]["out"], y, hw_g)
        lower_c = _conv_w(g["ppm"]["out"]).shape[0]

        f = p["feature_fusion"]
        lo, _ = self.resize_linear(lower, hw_g, hw8, align_corners=True,
                                   channels=lower_c)
        lo, _ = self.conv(f["dwconv"], lo, hw8, padding=1,
                          groups=_conv_w(f["dwconv"]).shape[0])
        lo, _ = self.conv(f["conv_lower_res"], lo, hw8, relu=False)
        hi, _ = self.conv(f["conv_higher_res"], higher, hw8, relu=False)
        fused = self.b.node("Add", [hi, lo])
        fused = self.b.node("Relu", [fused])

        c = p["classifier"]
        y, _ = self.ds(c["dsconv1"], fused, hw8,
                       channels=_conv_w(c["dsconv1"]["dw"]).shape[0])
        y, _ = self.ds(c["dsconv2"], y, hw8,
                       channels=_conv_w(c["dsconv2"]["dw"]).shape[0])
        logits, _ = self.conv(c["conv"], y, hw8, relu=False)

        auxout = None
        if aux and "auxlayer" in p:
            a = p["auxlayer"]
            z, _ = self.conv(a["conv1"], higher, hw8, padding=1)
            auxout, _ = self.conv(a["conv2"], z, hw8, relu=False)
        return logits, auxout, hw8


def emit_fastscnn_onnx(
    model,
    folded_params,
    input_shape: tuple[int, int, int, int],
    path: str | None = None,
    *,
    internal_size: tuple[int, int] | None = None,
    mean=None,
    std=None,
    output: str = "mask",
    include_aux: bool = False,
    doc: str = "",
) -> bytes:
    """Emit the end-to-end Fast-SCNN deploy graph as ONNX bytes.

    ``model`` — a :class:`fastscnn_tpu_torch.models.FastSCNN` (its
    ``num_classes``, ``ppm_sizes`` and ``ppm_align_corners`` are read);
    ``folded_params`` — BN-folded HWIO tree of numpy arrays
    (``fold_inference_params(model, torch.float32)`` moved to numpy; cast
    to f32 here); ``input_shape`` — static NCHW input, float32 in [0, 255]
    (the reference E2E contract, reference:export_onnx_fixed.py:62-78).

    ``output``: 'mask' (int64 argmax, nearest-resized back — the engine's
    predict path), 'softmax' (probabilities resized back with
    align_corners=False), or 'logits' (at input resolution).
    Mirrors ``InferenceEngine._build_predict`` / ``E2EConfig`` semantics.
    """
    if output not in ("mask", "softmax", "logits"):
        raise ValueError(f"output must be mask|softmax|logits, got {output!r}")
    n, cin, in_h, in_w = input_shape
    if cin != 3:
        raise ValueError(f"expected NCHW with C=3, got {input_shape}")

    b = OnnxGraphBuilder("fastscnn_e2e")
    b.graph_input("images", np.float32, input_shape)
    em = _Emitter(b, model.ppm_sizes, model.ppm_align_corners, batch=n)

    # preprocessing (InferenceEngine._preprocess)
    scale = b.initializer(np.float32(1.0 / 255.0), "inv255")
    x = b.node("Mul", ["images", scale])
    hw = (in_h, in_w)
    if internal_size is not None:
        x, hw = em.resize_linear(x, hw, tuple(internal_size),
                                 align_corners=False, channels=3)
    if mean is not None:
        m = b.initializer(_np_f32(mean).reshape(1, 3, 1, 1), "mean")
        x = b.node("Sub", [x, m])
        s = b.initializer(
            _np_f32(std if std is not None else (1.0,) * 3).reshape(1, 3, 1, 1), "std"
        )
        x = b.node("Div", [x, s])

    logits8, aux8, hw8 = em.backbone(
        folded_params, x, hw, model.num_classes, aux=include_aux
    )
    nc = model.num_classes
    # the network's final ×8 align_corners=True upsample
    logits, _ = em.resize_linear(logits8, hw8, hw, align_corners=True, channels=nc)

    if output == "softmax":
        probs = b.node("Softmax", [logits], axis=1)
        probs, _ = em.resize_linear(probs, hw, (in_h, in_w),
                                    align_corners=False, channels=nc)
        b.node("Identity", [probs], outputs=["probs"])
        b.graph_output("probs", np.float32, (n, model.num_classes, in_h, in_w))
    elif output == "mask":
        mask = b.node("ArgMax", [logits], axis=1, keepdims=0)
        if hw != (in_h, in_w):
            mask = b.node(
                "Resize", _resize_inputs(b, mask, (n, in_h, in_w)),
                mode="nearest", coordinate_transformation_mode="asymmetric",
                nearest_mode="floor",
            )
        b.node("Identity", [mask], outputs=["mask"])
        b.graph_output("mask", np.int64, (n, in_h, in_w))
    else:  # logits at input resolution (deployed-graph contract)
        logits, _ = em.resize_linear(logits, hw, (in_h, in_w),
                                     align_corners=False, channels=nc)
        b.node("Identity", [logits], outputs=["logits"])
        b.graph_output("logits", np.float32, (n, model.num_classes, in_h, in_w))

    if include_aux and aux8 is not None:
        auxl, _ = em.resize_linear(aux8, hw8, hw, align_corners=True, channels=nc)
        b.node("Identity", [auxl], outputs=["aux_logits"])
        b.graph_output("aux_logits", np.float32, (n, model.num_classes) + hw)

    data = b.serialize(doc=doc or (
        "Fast-SCNN end-to-end deploy graph emitted by fastscnn-tpu "
        "(reference:export_onnx_fixed.py parity; exact adaptive pooling)"
    ))
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


# ---------------------------------------------------------------------------
# ModelProto parsing (wire-format decode, no onnx package)
# ---------------------------------------------------------------------------


def _iter_fields(data: bytes):
    i, n = 0, len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            val, i = _read_varint(data, i)
        elif wire == _WIRE_F64:
            val, i = data[i:i + 8], i + 8
        elif wire == _WIRE_LEN:
            ln, i = _read_varint(data, i)
            val, i = data[i:i + ln], i + ln
        elif wire == _WIRE_F32:
            val, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _read_varint(data: bytes, i: int):
    result = shift = 0
    while True:
        byte = data[i]
        i += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, i
        shift += 7


def _varints_maybe_packed(wire, val):
    if wire == _WIRE_VARINT:
        return [val]
    out, i = [], 0
    while i < len(val):
        v, i = _read_varint(val, i)
        out.append(v)
    return out


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(data: bytes):
    dims, dt, name, raw = [], _DT_FLOAT, "", b""
    float_data, int32_data, int64_data = [], [], []
    for field, wire, val in _iter_fields(data):
        if field == 1:
            dims += [_signed64(v) for v in _varints_maybe_packed(wire, val)]
        elif field == 2:
            dt = val
        elif field == 4:
            if wire == _WIRE_F32:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data += list(np.frombuffer(val, dtype="<f4"))
        elif field == 5:
            int32_data += _varints_maybe_packed(wire, val)
        elif field == 7:
            int64_data += [_signed64(v) for v in _varints_maybe_packed(wire, val)]
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
    np_dt = _DT_TO_NP.get(dt)
    if np_dt is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dt}")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dt.newbyteorder("<")).astype(np_dt)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dt)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np_dt)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=np_dt)
    else:
        arr = np.zeros(0, dtype=np_dt)
    return name, arr.reshape(dims)


def _parse_attr(data: bytes):
    name, value = "", None
    a_type = None
    a_int, a_str = 0, ""  # proto3 omits zero/empty scalar fields
    ints, floats, strings = [], [], []
    for field, wire, val in _iter_fields(data):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:
            value = struct.unpack("<f", val)[0]
        elif field == 3:
            a_int = _signed64(val)
        elif field == 4:
            a_str = val.decode("utf-8")
        elif field == 5:
            value = _parse_tensor(val)[1]
        elif field == 7:
            if wire == _WIRE_F32:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats += list(np.frombuffer(val, dtype="<f4"))
        elif field == 8:
            ints += [_signed64(v) for v in _varints_maybe_packed(wire, val)]
        elif field == 9:
            strings.append(val.decode("utf-8"))
        elif field == 20:
            a_type = val
    if a_type == _AT_INT:
        value = a_int
    elif a_type == _AT_STRING:
        value = a_str
    elif a_type == _AT_INTS or (a_type is None and ints):
        value = ints
    elif a_type == _AT_FLOATS or (a_type is None and floats):
        value = [float(f) for f in floats]
    elif a_type == _AT_STRINGS:
        value = strings
    elif value is None and ints:
        value = ints
    return name, value


def _parse_node(data: bytes):
    node = SimpleNamespace(inputs=[], outputs=[], op_type="", name="", attrs={})
    for field, wire, val in _iter_fields(data):
        if field == 1:
            node.inputs.append(val.decode("utf-8"))
        elif field == 2:
            node.outputs.append(val.decode("utf-8"))
        elif field == 3:
            node.name = val.decode("utf-8")
        elif field == 4:
            node.op_type = val.decode("utf-8")
        elif field == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _parse_value_info(data: bytes):
    name, shape, elem = "", [], None
    for field, wire, val in _iter_fields(data):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:  # TypeProto
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim = None
                                    for f5, w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim = _signed64(v5)
                                    shape.append(dim)
    return SimpleNamespace(name=name, shape=shape, elem_type=elem)


def _parse_graph(data: bytes):
    g = SimpleNamespace(nodes=[], initializers={}, inputs=[], outputs=[], name="")
    for field, wire, val in _iter_fields(data):
        if field == 1:
            g.nodes.append(_parse_node(val))
        elif field == 2:
            g.name = val.decode("utf-8")
        elif field == 5:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif field == 11:
            g.inputs.append(_parse_value_info(val))
        elif field == 12:
            g.outputs.append(_parse_value_info(val))
    return g


def parse_onnx(data: bytes):
    """Decode ModelProto bytes into a light namespace tree (graph with
    nodes/initializers/inputs/outputs). The JAX package's tests
    cross-validate its field numbers against ``torch.onnx.export`` output."""
    model = SimpleNamespace(ir_version=None, opset=None, producer="", graph=None)
    for field, wire, val in _iter_fields(data):
        if field == 1:
            model.ir_version = val
        elif field == 2:
            model.producer = val.decode("utf-8")
        elif field == 7:
            model.graph = _parse_graph(val)
        elif field == 8:
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2:
                    model.opset = _signed64(v2)
    if model.graph is None:
        raise ValueError("no GraphProto in model bytes")
    return model


# ---------------------------------------------------------------------------
# numpy evaluator (the op set the emitter produces, plus torch-export basics)
# ---------------------------------------------------------------------------


def _np_conv(x, w, bias, strides, pads, group, dilations):
    if any(d != 1 for d in dilations):
        raise NotImplementedError("dilated conv")
    n, c, h, wd = x.shape
    m, cg, kh, kw = w.shape
    pt, pl, pb, pr = pads  # ONNX: [h_begin, w_begin, h_end, w_end]
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    sh, sw = strides
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    win = np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(2, 3))
    win = win[:, :, ::sh, ::sw]  # (n, c, oh, ow, kh, kw)
    if group == c and m == c:  # depthwise, multiplier 1
        y = np.einsum("nchwkl,ckl->nchw", win, w[:, 0], optimize=True)
    elif group == 1:
        y = np.einsum("nchwkl,mckl->nmhw", win, w, optimize=True)
    else:
        outs = []
        cpg, mpg = c // group, m // group
        for g in range(group):
            xg = win[:, g * cpg:(g + 1) * cpg]
            wg = w[g * mpg:(g + 1) * mpg]
            outs.append(np.einsum("nchwkl,mckl->nmhw", xg, wg, optimize=True))
        y = np.concatenate(outs, axis=1)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return np.ascontiguousarray(y.astype(np.float32))


def _np_avgpool(x, kernel, strides):
    kh, kw = kernel
    sh, sw = strides
    win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(2, 3))
    return win[:, :, ::sh, ::sw].mean(axis=(-2, -1)).astype(x.dtype)


def _resize_src(in_size, out_size, ctm):
    i = np.arange(out_size, dtype=np.float64)
    if ctm == "align_corners":
        if out_size == 1:
            return np.zeros(1)
        return i * (in_size - 1) / (out_size - 1)
    if ctm in ("half_pixel", "pytorch_half_pixel"):
        src = (i + 0.5) * in_size / out_size - 0.5
        if ctm == "pytorch_half_pixel" and out_size <= 1:
            return np.zeros(out_size)
        return src
    if ctm == "asymmetric":
        return i * in_size / out_size
    raise NotImplementedError(f"coordinate_transformation_mode {ctm}")


def _np_resize_axis_linear(x, axis, out_size, ctm):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    src = _resize_src(in_size, out_size, ctm)
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    shape = [1] * x.ndim
    shape[axis] = out_size
    t = t.reshape(shape)
    x_lo = np.take(x, lo, axis=axis)
    x_hi = np.take(x, hi, axis=axis)
    # same expression as ops/resize.py::_lerp_axis so near-tie argmaxes
    # agree bit-for-bit with the engine
    return (x_lo + (x_hi - x_lo) * t).astype(np.float32)


def _np_resize(x, sizes, attrs):
    mode = attrs.get("mode", "nearest")
    ctm = attrs.get("coordinate_transformation_mode", "half_pixel")
    out = list(x.shape)
    resize_axes = []
    for ax, s in enumerate(sizes):
        if s != x.shape[ax]:
            resize_axes.append(ax)
            out[ax] = int(s)
    if mode == "linear":
        y = x.astype(np.float32)
        for ax in resize_axes:
            y = _np_resize_axis_linear(y, ax, out[ax], ctm)
        return y
    if mode == "nearest":
        nearest_mode = attrs.get("nearest_mode", "round_prefer_floor")
        y = x
        for ax in resize_axes:
            src = _resize_src(x.shape[ax], out[ax], ctm)
            if nearest_mode == "floor":
                idx = np.floor(src).astype(np.int64)
            elif nearest_mode == "ceil":
                idx = np.ceil(src).astype(np.int64)
            else:  # round_prefer_floor: round half down
                idx = np.ceil(src - 0.5).astype(np.int64)
            idx = np.clip(idx, 0, y.shape[ax] - 1)
            y = np.take(y, idx, axis=ax)
        return y
    raise NotImplementedError(f"Resize mode {mode}")


def run_onnx(model, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Evaluate a parsed ONNX model with numpy. Covers the op set
    :func:`emit_fastscnn_onnx` produces (Conv/Relu/Add/Mul/Sub/Div/Concat/
    AveragePool/MatMul/Resize/Softmax/ArgMax/Identity) plus the basics
    torch's exporter emits for the cross-validation fixtures."""
    g = model.graph
    env: dict[str, np.ndarray] = dict(g.initializers)
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    env[""] = None

    for node in g.nodes:
        ins = [env[i] for i in node.inputs]
        a = node.attrs
        op = node.op_type
        if op == "Conv":
            pads = a.get("pads", [0, 0, 0, 0])
            y = _np_conv(
                ins[0], ins[1], ins[2] if len(ins) > 2 else None,
                a.get("strides", [1, 1]), pads, a.get("group", 1),
                a.get("dilations", [1, 1]),
            )
        elif op == "Relu":
            y = np.maximum(ins[0], 0)
        elif op == "Add":
            y = ins[0] + ins[1]
        elif op == "Sub":
            y = ins[0] - ins[1]
        elif op == "Mul":
            y = ins[0] * ins[1]
        elif op == "Div":
            y = ins[0] / ins[1]
        elif op == "Concat":
            y = np.concatenate(ins, axis=a["axis"])
        elif op == "MatMul":
            y = np.matmul(ins[0], ins[1]).astype(np.float32)
        elif op == "AveragePool":
            if any(a.get("pads", [])):
                raise NotImplementedError("padded AveragePool")
            y = _np_avgpool(ins[0], a["kernel_shape"], a.get("strides", a["kernel_shape"]))
        elif op == "GlobalAveragePool":
            y = ins[0].mean(axis=(2, 3), keepdims=True)
        elif op == "Resize":
            sizes = ins[3] if len(ins) > 3 and ins[3] is not None else None
            if sizes is None or len(np.atleast_1d(sizes)) == 0:
                scales = np.asarray(ins[2], dtype=np.float64)
                sizes = np.round(np.asarray(ins[0].shape) * scales).astype(np.int64)
            sizes = [int(s) for s in np.atleast_1d(sizes)]
            y = _np_resize(ins[0], sizes, a)
        elif op == "Softmax":
            axis = a.get("axis", -1)
            z = ins[0].astype(np.float32)
            z = z - z.max(axis=axis, keepdims=True)
            e = np.exp(z)
            y = e / e.sum(axis=axis, keepdims=True)
        elif op == "ArgMax":
            y = np.argmax(ins[0], axis=a.get("axis", 0)).astype(np.int64)
            if a.get("keepdims", 1):
                y = np.expand_dims(y, a.get("axis", 0))
        elif op == "Identity":
            y = ins[0]
        elif op == "Cast":
            y = ins[0].astype(_DT_TO_NP[a["to"]])
        elif op == "Reshape":
            shape = [int(s) for s in ins[1]]
            y = ins[0].reshape(shape)
        elif op == "Flatten":
            ax = a.get("axis", 1)
            y = ins[0].reshape(int(np.prod(ins[0].shape[:ax])), -1)
        elif op == "Gemm":
            x0 = ins[0].T if a.get("transA") else ins[0]
            w0 = ins[1].T if a.get("transB") else ins[1]
            y = a.get("alpha", 1.0) * (x0 @ w0)
            if len(ins) > 2:
                y = y + a.get("beta", 1.0) * ins[2]
        elif op == "MaxPool":
            kh, kw = a["kernel_shape"]
            sh, sw = a.get("strides", a["kernel_shape"])
            win = np.lib.stride_tricks.sliding_window_view(
                ins[0], (kh, kw), axis=(2, 3))
            y = win[:, :, ::sh, ::sw].max(axis=(-2, -1))
        elif op == "Constant":
            y = a["value"]
        elif op == "Shape":
            # torch's tracer wires Resize sizes through Shape→Slice→Concat
            y = np.asarray(ins[0].shape, dtype=np.int64)
        elif op == "Slice":
            data = ins[0]
            starts = np.atleast_1d(ins[1]).astype(np.int64)
            ends = np.atleast_1d(ins[2]).astype(np.int64)
            axes = (np.atleast_1d(ins[3]).astype(np.int64)
                    if len(ins) > 3 and ins[3] is not None
                    else np.arange(len(starts), dtype=np.int64))
            steps = (np.atleast_1d(ins[4]).astype(np.int64)
                     if len(ins) > 4 and ins[4] is not None
                     else np.ones(len(starts), dtype=np.int64))
            slicer = [slice(None)] * data.ndim
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                slicer[int(ax) % data.ndim] = slice(int(st), int(en), int(sp))
            y = data[tuple(slicer)]
        else:
            raise NotImplementedError(f"op {op} (node {node.name})")
        for out_name in node.outputs:
            env[out_name] = y

    return {o.name: env[o.name] for o in g.outputs}


class OnnxArtifact:
    """An emitted ``.onnx`` file as a callable with the engine's layout: a
    uint8 NHWC batch of the graph's input shape in, the engine's output
    out — (N, H, W, C) probabilities, (N, H, W) int64 masks or (N, H, W, C)
    logits — as numpy. Runs on onnxruntime when it is installed
    (``backend`` 'onnxruntime'), else on :func:`run_onnx` ('numpy')."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.model = parse_onnx(f.read())
        graph = self.model.graph
        self.input_name = graph.inputs[0].name
        n, c, h, w = graph.inputs[0].shape
        self.shape = (n, h, w, c)
        self.output_name = graph.outputs[0].name
        try:
            import onnxruntime as ort

            self._sess = ort.InferenceSession(path)
            self.backend = "onnxruntime"
        except ImportError:
            self._sess = None
            self.backend = "numpy"

    def __call__(self, images_nhwc_u8) -> np.ndarray:
        x = np.asarray(images_nhwc_u8).transpose(0, 3, 1, 2).astype(np.float32)
        if self._sess is not None:
            out = self._sess.run([self.output_name], {self.input_name: x})[0]
        else:
            out = run_onnx(self.model, {self.input_name: x})[self.output_name]
        out = np.asarray(out)
        return out.transpose(0, 2, 3, 1) if out.ndim == 4 else out
