"""Frozen TF1 GraphDef -> torch executor (the exact legacy Inception
metrics).

The OpenAI image IS / FID / sFID protocol runs the frozen 2015
``classify_image_graph_def.pb`` InceptionV3 under a TF1 session; only that
graph gives numbers comparable to published tables.  This module (the port
of ``mm_diffusion_tpu/evaluation/graphdef.py``) executes the frozen graph
itself: the GraphDef protobuf is parsed in pure Python (wire decoding shared
with :mod:`.tf_bundle`; no TensorFlow, no protobuf runtime), and each node
is evaluated with torch ops on the executor's device.

The op set covers the Inception classifier family: Conv2D (TF-SAME padded
explicitly, more at the end), the legacy BatchNormWithGlobalNormalization,
Max / AvgPool (SAME average pools divide by the valid element count),
ResizeBilinear on TF1's legacy grid, Concat[V2], MatMul, Softmax, ...;
an unknown op raises by name.  ``batch_agnostic=True`` relaxes frozen
batch-1 ``Reshape`` targets to ``-1`` (the OpenAI evaluator's
``_update_shapes`` patch), so any batch runs.

:class:`InceptionV3Features` is the evaluator's contract on top: feed
``ExpandDims:0`` with float images in [0, 255], fetch ``pool_3:0`` (2048-d)
and ``mixed_6/conv:0[..., :7]`` (sFID's spatial head); the IS softmax is
``acts @ W`` with the graph's ``softmax/logits/MatMul`` weight and no bias.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .tf_bundle import _np_dtype, _proto_fields, _read_varint

# ---------------------------------------------------------------------------
# protobuf decoding: GraphDef / NodeDef / AttrValue / TensorProto
# ---------------------------------------------------------------------------


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_signed(v))
    return out


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for f, _w, v in _proto_fields(buf):
        if f == 2:  # Dim
            size = 0
            for f2, _w2, v2 in _proto_fields(v):
                if f2 == 1:
                    size = _signed(v2)
            dims.append(size)
    return tuple(dims)


# TensorProto typed-value fields (tensor.proto): 5 float_val, 6 double_val,
# 7 int_val, 10 int64_val, 11 bool_val, 13 half_val (uint16 bit patterns).
_TYPED_VAL_FIELDS = {5, 6, 7, 10, 11, 13}


def _parse_tensor(buf: bytes) -> np.ndarray:
    dtype_enum = 1
    shape: Tuple[int, ...] = ()
    content = b""
    vals: List[Any] = []
    for f, w, v in _proto_fields(buf):
        if f == 1:
            dtype_enum = v
        elif f == 2:
            shape = _parse_shape(v)
        elif f == 4:
            content = v
        elif f in _TYPED_VAL_FIELDS:
            if f == 5 and w == 5:  # float_val, unpacked
                vals.append(struct.unpack("<f", v.to_bytes(4, "little"))[0])
            elif f == 5 and w == 2:  # float_val, packed
                vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
            elif f == 6 and w == 1:  # double_val, unpacked
                vals.append(struct.unpack("<d", v.to_bytes(8, "little"))[0])
            elif f == 6 and w == 2:  # double_val, packed
                vals.extend(struct.unpack(f"<{len(v) // 8}d", v))
            elif f == 13:  # half_val: uint16 bit patterns of float16
                raw = _packed_varints(v) if w == 2 else [_signed(v)]
                vals.extend(
                    np.array(raw, np.uint16).view(np.float16).tolist()
                )
            elif w == 0:  # int_val / int64_val / bool_val, unpacked
                vals.append(_signed(v))
            elif w == 2:  # same, packed
                vals.extend(_packed_varints(v))
    dtype = _np_dtype(dtype_enum)
    size = int(np.prod(shape)) if shape else 1
    if content:
        arr = np.frombuffer(content, dtype=dtype.newbyteorder("<")).astype(dtype)
    else:
        if not vals:
            vals = [0]
        if len(vals) < size:  # TF splat semantics: last value repeats
            vals = vals + [vals[-1]] * (size - len(vals))
        arr = np.array(vals[:size], dtype=dtype)
    return arr.reshape(shape)


class AttrValue:
    """Decoded attr_value.proto oneof (only the fields classifiers use)."""

    __slots__ = ("s", "i", "f", "b", "type", "shape", "tensor", "list_i", "list_s")

    def __init__(self, buf: bytes):
        self.s = None
        self.i = None
        self.f = None
        self.b = None
        self.type = None
        self.shape = None
        self.tensor = None
        self.list_i: List[int] = []
        self.list_s: List[bytes] = []
        for f, w, v in _proto_fields(buf):
            if f == 2:
                self.s = v
            elif f == 3:
                self.i = _signed(v)
            elif f == 4:
                self.f = struct.unpack("<f", v.to_bytes(4, "little"))[0]
            elif f == 5:
                self.b = bool(v)
            elif f == 6:
                self.type = v
            elif f == 7:
                self.shape = _parse_shape(v)
            elif f == 8:
                self.tensor = _parse_tensor(v)
            elif f == 1:  # ListValue
                for f2, w2, v2 in _proto_fields(v):
                    if f2 == 3:
                        if w2 == 2:
                            self.list_i.extend(_packed_varints(v2))
                        else:
                            self.list_i.append(_signed(v2))
                    elif f2 == 2:
                        self.list_s.append(v2)


class NodeDef:
    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self, buf: bytes):
        self.name = ""
        self.op = ""
        self.inputs: List[str] = []
        self.attrs: Dict[str, AttrValue] = {}
        for f, _w, v in _proto_fields(buf):
            if f == 1:
                self.name = v.decode("utf-8")
            elif f == 2:
                self.op = v.decode("utf-8")
            elif f == 3:
                self.inputs.append(v.decode("utf-8"))
            elif f == 5:  # map<string, AttrValue> entry
                key, val = "", None
                for f2, _w2, v2 in _proto_fields(v):
                    if f2 == 1:
                        key = v2.decode("utf-8")
                    elif f2 == 2:
                        val = AttrValue(v2)
                if val is not None:
                    self.attrs[key] = val


def parse_graphdef(data: bytes) -> List[NodeDef]:
    return [NodeDef(v) for f, _w, v in _proto_fields(data) if f == 1]


# ---------------------------------------------------------------------------
# op interpreter
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {
    np.dtype("float32"): torch.float32, np.dtype("float64"): torch.float64,
    np.dtype("float16"): torch.float16, np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64, np.dtype("uint8"): torch.uint8,
    np.dtype("int16"): torch.int16, np.dtype("int8"): torch.int8, np.dtype("bool"): torch.bool,
}


def _same_pads(sizes, kernel, stride) -> Tuple[int, ...]:
    """TF-SAME padding of NCHW's H and W in ``F.pad``'s order, the larger
    half at the end."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads[1] + pads[0]


def _tf_resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """TF1 ResizeBilinear (half_pixel_centers=False) on NHWC: the legacy
    grid ``src = i * in / out`` (``i * (in - 1) / (out - 1)`` when
    align_corners), not the half-pixel grid of ``F.interpolate``."""
    n, in_h, in_w, c = x.shape
    out_h, out_w = int(out_hw[0]), int(out_hw[1])

    def axis_coords(in_dim, out_dim):
        if align_corners and out_dim > 1:
            scale = (in_dim - 1) / (out_dim - 1)
        else:
            scale = in_dim / out_dim
        src = torch.arange(out_dim, dtype=torch.float32, device=x.device) * scale
        lo = torch.clamp(torch.floor(src), 0, in_dim - 1).long()
        hi = torch.clamp(lo + 1, max=in_dim - 1)
        return lo, hi, src - lo.float()

    ylo, yhi, yf = axis_coords(in_h, out_h)
    xlo, xhi, xf = axis_coords(in_w, out_w)
    x = x.float()
    xf = xf[None, None, :, None]
    top = x[:, ylo][:, :, xlo] * (1 - xf) + x[:, ylo][:, :, xhi] * xf
    bot = x[:, yhi][:, :, xlo] * (1 - xf) + x[:, yhi][:, :, xhi] * xf
    yf = yf[None, :, None, None]
    return top * (1 - yf) + bot * yf


def _pool(x: torch.Tensor, attrs, kind: str) -> torch.Tensor:
    """TF Max / AvgPool on NHWC (ksize and strides ``[1, kh, kw, 1]``)."""
    kernel = tuple(attrs["ksize"].list_i[1:3])
    stride = tuple(attrs["strides"].list_i[1:3])
    padding = attrs["padding"].s.decode()
    h = x.permute(0, 3, 1, 2)
    pads = _same_pads(h.shape[2:], kernel, stride) if padding == "SAME" else (0, 0, 0, 0)
    if kind == "max":
        out = F.max_pool2d(F.pad(h, pads, value=float("-inf")), kernel, stride)
    else:
        total = F.avg_pool2d(F.pad(h.float(), pads), kernel, stride, divisor_override=1)
        # TF SAME average pooling divides by the valid element count
        ones = F.pad(torch.ones((1, 1) + tuple(h.shape[2:]), device=h.device), pads)
        out = (total / F.avg_pool2d(ones, kernel, stride, divisor_override=1)).to(h.dtype)
    return out.permute(0, 2, 3, 1)


class GraphDefExecutor:
    """Interpret a frozen GraphDef with torch ops on ``device``.

    ``run(fetches, feeds)`` evaluates tensor names (``node`` or ``node:i``)
    given fed tensors, memoised per call.  Const nodes stay numpy where
    they give shapes and axes, and are moved to the device once where they
    enter arithmetic.
    """

    def __init__(self, graph: Union[str, bytes], batch_agnostic: bool = True, device="cpu"):
        if isinstance(graph, str):
            with open(graph, "rb") as f:
                graph = f.read()
        self.nodes: Dict[str, NodeDef] = {n.name: n for n in parse_graphdef(graph)}
        self.batch_agnostic = batch_agnostic
        self.device = torch.device(device)
        self._consts = {id(n.attrs["value"].tensor): n.attrs["value"].tensor
                        for n in self.nodes.values() if n.op == "Const" and "value" in n.attrs}
        self._on_device: Dict[int, torch.Tensor] = {}

    # -- graph utilities ---------------------------------------------------

    def const_value(self, name: str) -> np.ndarray:
        """A Const node's tensor (e.g. the IS softmax weight), without
        running anything."""
        node = self.nodes[name.split(":")[0]]
        if node.op != "Const":
            raise ValueError(f"{node.name!r} is a {node.op}, not a Const")
        value = node.attrs.get("value")
        return _parse_tensor(b"") if value is None else value.tensor

    def as_torch_fn(self, fetches: Sequence[str], feed_names: Sequence[str]):
        """A positional-argument callable: ``fn(*feeds) -> [fetched]``."""

        def fn(*args):
            return self.run(fetches, dict(zip(feed_names, args)))

        return fn

    # -- evaluation ---------------------------------------------------------

    def run(self, fetches: Sequence[str], feeds: Dict[str, Any]) -> List[Any]:
        feeds = {self._canon(k): self._tensor(v) for k, v in feeds.items()}
        memo: Dict[str, Any] = dict(feeds)
        with torch.no_grad():
            return [self._eval(self._canon(name), memo) for name in fetches]

    @staticmethod
    def _canon(name: str) -> str:
        name = name.lstrip("^")
        return name if ":" in name else name + ":0"

    def _tensor(self, x) -> torch.Tensor:
        """``x`` as a tensor on the device; a Const node's array is moved
        once and kept there."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if self._consts.get(id(x)) is x:
            if id(x) not in self._on_device:
                self._on_device[id(x)] = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return self._on_device[id(x)]
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _eval(self, tensor: str, memo: Dict[str, Any]):
        if tensor in memo:
            return memo[tensor]
        node_name, out_idx = tensor.rsplit(":", 1)
        # iterative DFS so deep classifier chains don't hit the recursion cap
        stack = [node_name]
        while stack:
            name = stack[-1]
            if self._canon(name) in memo:
                stack.pop()
                continue
            node = self.nodes.get(name)
            if node is None:
                raise KeyError(f"graph has no node {name!r}")
            deps = [self._canon(i) for i in node.inputs if not i.startswith("^")]
            missing = [d for d in deps if d not in memo]
            if missing:
                stack.extend(m.rsplit(":", 1)[0] for m in missing)
                continue
            outs = self._apply(node, [memo[d] for d in deps])
            if not isinstance(outs, tuple):
                outs = (outs,)
            for i, o in enumerate(outs):
                memo[f"{name}:{i}"] = o
            stack.pop()
        return memo[f"{node_name}:{out_idx}"]

    def _apply(self, node: NodeDef, inputs: List[Any]):
        op = node.op
        a = node.attrs
        t = self._tensor
        if op == "Const":
            return a["value"].tensor  # numpy: it may be a shape or an axis
        if op == "Placeholder":
            raise ValueError(f"placeholder {node.name!r} was not fed (feeds must cover it)")
        if op in ("Identity", "CheckNumerics", "StopGradient", "PreventGradient"):
            return inputs[0]
        if op == "Cast":
            dtype = _np_dtype(a["DstT"].type)
            if isinstance(inputs[0], np.ndarray):
                return inputs[0].astype(dtype)
            return inputs[0].to(_TORCH_DTYPES[dtype])
        if op == "ExpandDims":
            return t(inputs[0]).unsqueeze(int(inputs[1]))
        if op == "Squeeze":
            dims = a["squeeze_dims"].list_i if "squeeze_dims" in a else None
            x = t(inputs[0])
            return x.squeeze(tuple(dims)) if dims else x.squeeze()
        if op == "Reshape":
            target = [int(d) for d in np.asarray(inputs[1]).reshape(-1)]
            x = t(inputs[0])
            if (self.batch_agnostic and target and target[0] == 1 and -1 not in target
                    and x.shape[0] != 1):
                target[0] = -1  # a frozen batch-1 graph runs any batch
            return x.reshape(target)
        if op in ("Sub", "Mul", "Add", "AddV2", "RealDiv", "Maximum", "Minimum"):
            f = {
                "Sub": torch.sub, "Mul": torch.mul, "Add": torch.add, "AddV2": torch.add,
                "RealDiv": torch.div, "Maximum": torch.maximum, "Minimum": torch.minimum,
            }[op]
            return f(t(inputs[0]), t(inputs[1]))
        if op == "BiasAdd":
            return t(inputs[0]) + t(inputs[1])
        if op == "Relu":
            return F.relu(t(inputs[0]))
        if op == "Relu6":
            return t(inputs[0]).clamp(0, 6)
        if op == "Softmax":
            return torch.softmax(t(inputs[0]), dim=-1)
        if op == "Conv2D":
            x, w = t(inputs[0]).permute(0, 3, 1, 2), t(inputs[1])  # NCHW; HWIO
            stride = (int(a["strides"].list_i[1]), int(a["strides"].list_i[2]))
            if a["padding"].s.decode() == "SAME":
                x = F.pad(x, _same_pads(x.shape[2:], w.shape[:2], stride))
            return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
        if op == "BatchNormWithGlobalNormalization":
            x, m, v, beta, gamma = (t(i) for i in inputs)
            inv = torch.rsqrt(v + a["variance_epsilon"].f)
            if a["scale_after_normalization"].b:
                inv = inv * gamma
            return x * inv + (beta - m * inv)
        if op in ("FusedBatchNorm", "FusedBatchNormV3"):
            x, gamma, beta, m, v = (t(i) for i in inputs[:5])
            inv = torch.rsqrt(v + a["epsilon"].f) * gamma
            return x * inv + (beta - m * inv)
        if op == "MaxPool":
            return _pool(t(inputs[0]), a, "max")
        if op == "AvgPool":
            return _pool(t(inputs[0]), a, "avg")
        if op == "Concat":  # axis first (TF1)
            return torch.cat([t(i) for i in inputs[1:]], dim=int(inputs[0]))
        if op == "ConcatV2":  # axis last
            return torch.cat([t(i) for i in inputs[:-1]], dim=int(inputs[-1]))
        if op == "MatMul":
            x, w = t(inputs[0]), t(inputs[1])
            if a.get("transpose_a") is not None and a["transpose_a"].b:
                x = x.T
            if a.get("transpose_b") is not None and a["transpose_b"].b:
                w = w.T
            return x @ w
        if op == "ResizeBilinear":
            align = a.get("align_corners")
            return _tf_resize_bilinear(t(inputs[0]), np.asarray(inputs[1]), bool(align.b) if align else False)
        if op == "Shape":
            return np.array(inputs[0].shape, np.int32)
        if op == "Pad":
            pads = np.asarray(inputs[1])
            return F.pad(t(inputs[0]), tuple(int(p) for lo_hi in pads[::-1] for p in lo_hi))
        raise NotImplementedError(
            f"GraphDef op {op!r} (node {node.name!r}) is not implemented -- "
            "extend GraphDefExecutor._apply if the frozen graph needs it"
        )


# ---------------------------------------------------------------------------
# the evaluator's Inception contract
# ---------------------------------------------------------------------------

FID_POOL_NAME = "pool_3:0"
FID_SPATIAL_NAME = "mixed_6/conv:0"
_INPUT_NAME = "ExpandDims:0"


class InceptionV3Features:
    """``classify_image_graph_def.pb`` with the OpenAI evaluator's tensor
    contract on ``device``: images in [0, 255] NHWC float -> (pool_3
    ``[N, 2048]``, ``mixed_6/conv[..., :7]`` ``[N, 2023]``); the IS softmax
    is ``acts @ W`` (no bias)."""

    def __init__(self, pb_path: str, device="cuda"):
        self.executor = GraphDefExecutor(pb_path, batch_agnostic=True, device=device)
        matmul = self.executor.nodes["softmax/logits/MatMul"]
        self._softmax_w = np.asarray(self.executor.const_value(matmul.inputs[1]))
        self._features = self.executor.as_torch_fn([FID_POOL_NAME, FID_SPATIAL_NAME], [_INPUT_NAME])

    def features(self, images_0_255: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        pool, spatial = self._features(np.asarray(images_0_255, np.float32))
        pool, spatial = pool.cpu().numpy(), spatial.cpu().numpy()
        n = pool.shape[0]
        return pool.reshape(n, -1), spatial[..., :7].reshape(n, -1)

    def softmax(self, pool_acts: np.ndarray) -> np.ndarray:
        logits = np.asarray(pool_acts, np.float32) @ self._softmax_w
        logits = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        return e / e.sum(axis=-1, keepdims=True)


def inception_score_openai(preds: np.ndarray, split_size: int = 5000) -> float:
    """IS over softmax predictions (the OpenAI evaluator's / improved-gan's)."""
    scores = []
    for i in range(0, len(preds), split_size):
        part = preds[i : i + split_size]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores))
