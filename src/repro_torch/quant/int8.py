"""int8 integer-arithmetic-only inference (paper §3.1.2) on torch — the
twin of the reference's ``repro.quant.int8``.

Follows the structure of TFLite's integer-only inference [Jacob et al.]:
weights and activations are 8-bit integers; matmul/conv accumulate in
int32 and *requantize* to int8 with a per-tensor scale.  The paper's
Insight 2 hinges on the cost structure this creates:

  * conv / dwconv / FC: int8 MACs + one requant per output;
  * element-wise add/mul: inputs with different scales must be RESCALED
    to a common scale before the op — pure overhead that makes quantized
    element-wise ops slower than float (paper Fig. 5).

Static per-tensor scales and float multipliers for requantization, as
the reference.

Where the work runs.  `fully_connected` and every dense convolution
(groups = 1; an int8 Winograd op is a plain convolution, as in the
reference) are one int8 GEMM: a 1×1 convolution directly, a k×k one
after an im2col gather in torch.  The GEMM is the hand-written CUDA
kernel on the card and its plain version on the host
(`repro_torch.kernels.int8_matmul`); its int32 bias is added to the
integer sum before the kernel's single float32 scale, which is the
requantize multiplier, so the rounding and clipping after it are
`requantize` bit for bit.  Depthwise and grouped convolutions are int32
shifted multiply-adds in torch, exact on either device.

Bit-exact with the reference's jitted op callables:
  * ``x / scale`` is computed as ``x · f32(1/f32(scale))``, which is what
    XLA makes of a division by a constant under ``jit``, on every device
    (torch's CUDA division by a host scalar is also a reciprocal
    multiply, its CPU division is not);
  * every multiplier is a Python float rounded once to float32
    (``f32(in_scale / out_scale)``), as JAX's weak typing does;
  * rounding is half to even, and widths and clip order follow the
    reference (int16 rescaled add/sub/max/min, int32 sums).
The float round trips of hswish, relu6, sqrt, abs, square and the like
are exact too.  exp, log, sigmoid, swish, gelu and tanh use torch's own
transcendental functions, which can differ from XLA's in the last bit;
an element next to a rounding boundary then moves by one quantization
step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.executor import _conv_weights, _same_pads, _weight_seed, make_array
from repro_torch.kernels.int8_matmul import int8_matmul_packed, pack_weight
from repro_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

# Static scales: activations ~N(0, 1) → scale so ±4σ spans int8.
ACT_SCALE = 4.0 / 127.0
WEIGHT_SCALE = 0.4 / 127.0
RELU6_Q = round(6.0 / ACT_SCALE)
# Row stride unit of the im2col patches, in bytes (the GEMM's cp.async width).
PATCH_ALIGN = 16

# Unary kinds whose float round trip goes through a transcendental
# function (see the module docstring).
TRANSCENDENTAL = frozenset({"exp", "log", "sigmoid", "swish", "gelu", "tanh"})


def _f32(v: float) -> float:
    return float(np.float32(v))


def _round_clip(y: Tensor) -> Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def quantize_symmetric(x: Tensor, scale: float) -> Tensor:
    inv = float(np.float32(1) / np.float32(scale))
    return _round_clip(x * inv)


def dequantize(q: Tensor, scale: float) -> Tensor:
    return q.to(torch.float32) * _f32(scale)


def requantize(acc: Tensor, in_scale: float, out_scale: float) -> Tensor:
    """int32 accumulator → int8 output (one mul + round + clip per element)."""
    return _round_clip(acc.to(torch.float32) * _f32(in_scale / out_scale))


def rescale_int8(q: Tensor, in_scale: float, out_scale: float) -> Tensor:
    """Match quantization ranges of element-wise inputs (paper Insight 2):
    mul + round + clip on EVERY element before the actual op."""
    return _round_clip(q.to(torch.float32) * _f32(in_scale / out_scale))


# ---------------------------------------------------------------------------
# Float round trips (jax.nn's definitions, in the reference's op order)
# ---------------------------------------------------------------------------

_ONE_SIXTH = float(np.float32(1) / np.float32(6))
_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi).astype(np.float32))


def _hard_swish(x: Tensor) -> Tensor:
    # jax.nn.hard_swish = x · (relu6(x + 3) / 6), the division a multiply
    # by f32(1/6) under jit.
    return x * (torch.clamp(x + 3.0, 0.0, 6.0) * _ONE_SIXTH)


def _gelu_tanh(x: Tensor) -> Tensor:
    # jax.nn.gelu's default (approximate=True) form; x**3 is (x·x)·x.
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


_FLOAT_UNARY: Dict[str, Callable[[Tensor], Tensor]] = {
    "exp": torch.exp, "log": lambda x: torch.log(torch.abs(x) + 1e-3),
    "sqrt": lambda x: torch.sqrt(torch.abs(x)), "square": lambda x: x * x,
    "abs": torch.abs, "neg": torch.neg, "copy": lambda x: x,
    "relu": torch.relu, "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "hswish": _hard_swish, "swish": lambda x: x * torch.sigmoid(x),
    "sigmoid": torch.sigmoid, "gelu": _gelu_tanh, "tanh": torch.tanh,
    "identity": lambda x: x,
}


def _float_unary(kind: str) -> Callable[[Tensor], Tensor]:
    return _FLOAT_UNARY.get(kind, lambda x: x)


def _lut_roundtrip(q: Tensor, kind: str) -> Tensor:
    """Unary op via the LUT-equivalent float round trip."""
    return quantize_symmetric(_float_unary(kind)(dequantize(q, ACT_SCALE)),
                              ACT_SCALE)


# ---------------------------------------------------------------------------
# Integer convolutions
# ---------------------------------------------------------------------------

def _pad_for(x: Tensor, kh: int, kw: int, stride: int, padding: str,
             value: int = 0) -> Tensor:
    """NHWC ``x`` padded as XLA pads for ``padding`` (SAME or VALID)."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"unsupported conv padding {padding!r}")
    hl, hh = _same_pads(x.shape[1], kh, stride)
    wl, wh = _same_pads(x.shape[2], kw, stride)
    if hl or hh or wl or wh:
        x = F.pad(x, (0, 0, wl, wh, hl, hh), value=value)
    return x


def _windows(xp: Tensor, kh: int, kw: int, stride: int) -> Tensor:
    """(B, OH, OW, C, kh, kw) view of the stride-``stride`` windows of a
    padded NHWC tensor."""
    return xp.unfold(1, kh, stride).unfold(2, kw, stride)


def _im2col(xp: Tensor, kh: int, kw: int, stride: int
            ) -> Tuple[Tensor, Tuple[int, int, int]]:
    """(B·OH·OW, kh·kw·C) int8 patches in HWIO order, and (B, OH, OW).

    Where the patches are gathered (a k×k or strided 1×1 convolution),
    they are written into a buffer whose rows start every `PATCH_ALIGN`
    bytes, and the result is its (rows, kh·kw·C) view: the int8 GEMM
    kernel copies such rows to shared memory with 16-byte ``cp.async``.
    The pad bytes past kh·kw·C are never read as values."""
    b, hp, wp, c = xp.shape
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    if kh == kw == 1 and stride == 1:
        return xp[:, :oh, :ow].reshape(b * oh * ow, c).contiguous(), (b, oh, ow)
    width = kh * kw * c
    ld = -(-width // PATCH_ALIGN) * PATCH_ALIGN
    cols = torch.empty((b * oh * ow, ld), dtype=xp.dtype, device=xp.device)[:, :width]
    cols.view(b, oh, ow, kh, kw, c).copy_(
        _windows(xp, kh, kw, stride).permute(0, 1, 2, 4, 5, 3))
    return cols, (b, oh, ow)


def _grouped_acc(xp: Tensor, w_q: Tensor, stride: int, groups: int) -> Tensor:
    """int32 grouped convolution of a padded NHWC int8 tensor by shifted
    multiply-adds: one pass per tap and input channel of a group."""
    kh, kw, cg, k = w_q.shape
    b, hp, wp, c = xp.shape
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    x32 = xp.to(torch.int32)
    w32 = w_q.to(torch.int32).reshape(kh, kw, cg, groups, k // groups)
    acc = torch.zeros((b, oh, ow, groups, k // groups), dtype=torch.int32,
                      device=xp.device)
    for i in range(kh):
        for j in range(kw):
            tap = x32[:, i:i + (oh - 1) * stride + 1:stride,
                      j:j + (ow - 1) * stride + 1:stride, :]
            tap = tap.reshape(b, oh, ow, groups, cg)
            for ci in range(cg):
                acc += tap[..., ci:ci + 1] * w32[i, j, ci]
    return acc.reshape(b, oh, ow, k)


def _q_act(y: Tensor, act: str) -> Tensor:
    if act in ("relu", "relu6"):
        y = torch.clamp_min(y, 0)
        if act == "relu6":
            y = torch.clamp_max(y.to(torch.int32), RELU6_Q).to(torch.int8)
    elif act in ("hswish", "swish", "sigmoid", "gelu", "tanh"):
        # Non-piecewise activations run dequant→float→requant (as TFLite's
        # LUT path).
        y = _lut_roundtrip(y, act)
    return y


# ---------------------------------------------------------------------------
# Quantized op builders (mirror repro_torch.core.executor.build_op_fn)
# ---------------------------------------------------------------------------

def _ew_rescaled(kind: str, a: Tensor, b: Tensor) -> Tensor:
    """add/sub/maximum/minimum of two int8 tensors at the common scale
    1.5·ACT_SCALE, in int16, clipped."""
    a16 = rescale_int8(a, ACT_SCALE, ACT_SCALE * 1.5).to(torch.int16)
    b16 = rescale_int8(b, ACT_SCALE, ACT_SCALE * 1.5).to(torch.int16)
    op = {"add": torch.add, "sub": torch.sub,
          "maximum": torch.maximum, "minimum": torch.minimum}[kind]
    return torch.clamp(op(a16, b16), -127, 127).to(torch.int8)


def _ew_mul(a: Tensor, b: Tensor) -> Tensor:
    acc = a.to(torch.int32) * b.to(torch.int32)
    return requantize(acc, ACT_SCALE * ACT_SCALE, ACT_SCALE)


def _make_tail(node) -> Callable[[Tensor, Sequence[Tensor]], Tensor]:
    def tail(y: Tensor, extras: Sequence[Tensor]) -> Tensor:
        it = iter(extras)
        for kind in node.fused:
            # "@self" duplicate-operand markers (fusion diamond collapse)
            # fall back to the running value, as in the reference.
            kind = kind.split("@", 1)[0]
            if kind in ("add", "sub", "maximum", "minimum"):
                rhs = next(it, None)
                y = _ew_rescaled(kind, y, rhs if rhs is not None else y)
            elif kind == "mul":
                rhs = next(it, None)
                y = _ew_mul(y, rhs if rhs is not None else y)
            else:  # unary/activation via LUT-equivalent float round trip
                y = _lut_roundtrip(y, kind)
        return y
    return tail


def _quant_weight(w: np.ndarray) -> np.ndarray:
    return np.clip(np.round(w / WEIGHT_SCALE), -127, 127).astype(np.int8)


def _conv_groups(graph, node) -> int:
    if node.op_type == "dwconv2d":
        return graph.tensor(node.inputs[0]).shape[-1]
    return node.params_dict.get("groups", 1)


def uses_int8_gemm(graph, node) -> bool:
    """Whether `build_quant_op_fn` runs ``node`` as one int8 GEMM:
    `fully_connected` and every dense convolution (groups = 1); depthwise
    and grouped convolutions are shifted multiply-adds."""
    t = node.op_type
    if t == "fully_connected":
        return True
    return (t in ("conv2d", "grouped_conv2d", "winograd_conv2d", "dwconv2d")
            and _conv_groups(graph, node) == 1)


def build_quant_op_fn(graph, node, device: DeviceLike = "cuda"
                      ) -> Tuple[Callable, List[int]]:
    """int8 analogue of executor.build_op_fn; weights on ``device``.
    Inputs/outputs are int8."""
    dev = resolve_device(device)
    t = node.op_type
    p = node.params_dict
    n_base = p.get("n_inputs", 1)
    tail = _make_tail(node)

    def upload(a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if t in ("conv2d", "grouped_conv2d", "winograd_conv2d", "dwconv2d"):
        # Winograd is never selected for int8 (TFLite restriction); treat
        # as standard conv.
        w, _ = _conv_weights(node, graph)
        w_q = _quant_weight(w)
        kh, kw, _, out_c = w_q.shape
        bias = upload(np.zeros((out_c,), np.int32))
        stride = p.get("stride", 1)
        groups = _conv_groups(graph, node)
        act = p.get("act", "")
        padding = p.get("padding", "SAME")
        if uses_int8_gemm(graph, node):
            bt = pack_weight(upload(w_q.reshape(kh * kw * w_q.shape[2], out_c)))
            scale = _f32(ACT_SCALE * WEIGHT_SCALE / ACT_SCALE)

            def fn(*xs):
                cols, (b, oh, ow) = _im2col(_pad_for(xs[0], kh, kw, stride, padding),
                                            kh, kw, stride)
                y = _round_clip(int8_matmul_packed(cols, bt, scale, bias))
                return tail(_q_act(y.reshape(b, oh, ow, out_c), act),
                            list(xs[n_base:]))
            return fn, list(node.inputs)

        wt = upload(w_q)

        def fn(*xs):
            acc = _grouped_acc(_pad_for(xs[0], kh, kw, stride, padding), wt,
                               stride, groups) + bias
            y = requantize(acc, ACT_SCALE * WEIGHT_SCALE, ACT_SCALE)
            return tail(_q_act(y, act), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "fully_connected":
        in_c = graph.tensor(node.inputs[0]).shape[-1]
        out_c = graph.tensor(node.outputs[0]).shape[-1]
        w = make_array((in_c, out_c), "float32", _weight_seed(node, (in_c, out_c), "w"))
        bt = pack_weight(upload(_quant_weight(w)))
        scale = _f32(ACT_SCALE * WEIGHT_SCALE / ACT_SCALE)
        out_shape = tuple(graph.tensor(node.outputs[0]).shape)
        act = p.get("act", "")

        def fn(*xs):
            a = xs[0].reshape(-1, in_c).contiguous()
            y = _round_clip(int8_matmul_packed(a, bt, scale))
            if act == "relu":
                y = torch.clamp_min(y, 0)
            return tail(y.reshape(out_shape), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "mean":
        keep = p.get("keepdims", False)

        def fn(*xs):
            acc = torch.sum(xs[0].to(torch.int32), dim=(1, 2), keepdim=keep,
                            dtype=torch.int32)
            denom = xs[0].shape[1] * xs[0].shape[2]
            return tail(requantize(acc, ACT_SCALE / denom, ACT_SCALE),
                        list(xs[n_base:]))
        return fn, list(node.inputs)

    if t in ("pool_avg", "pool_max"):
        k = (p.get("kernel_h", 1), p.get("kernel_w", 1))
        s = p.get("stride", 1)

        def fn(*xs):
            if t == "pool_max":
                xp = _pad_for(xs[0], k[0], k[1], s, "SAME", value=-128)
                y = _windows(xp, k[0], k[1], s).amax(dim=(-2, -1))
                return tail(y, list(xs[n_base:]))
            xp = _pad_for(xs[0].to(torch.int32), k[0], k[1], s, "SAME")
            acc = _windows(xp, k[0], k[1], s).sum(dim=(-2, -1), dtype=torch.int32)
            # Paper Fig. 5: quantized padding/pool degrade — requant cost.
            return tail(requantize(acc, ACT_SCALE / (k[0] * k[1]), ACT_SCALE),
                        list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "concat":
        axis = p.get("axis", -1)

        def fn(*xs):
            # Inputs may carry different scales → rescale each (overhead).
            parts = [rescale_int8(x, ACT_SCALE, ACT_SCALE) for x in xs[:n_base]]
            return tail(torch.cat(parts, dim=axis), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "split":
        n = p.get("num_splits", 2)
        axis = p.get("axis", -1)

        def fn(*xs):
            return tuple(torch.tensor_split(xs[0], n, dim=axis))
        return fn, list(node.inputs)

    if t == "pad":
        pads = p.get("paddings", ((0, 0), (1, 1), (1, 1), (0, 0)))
        flat_pads = [int(v) for q in reversed(pads) for v in q]

        def fn(*xs):
            return tail(F.pad(xs[0], flat_pads), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "channel_shuffle":
        g = p.get("groups", 2)

        def fn(*xs):
            b_, h, w_, c = xs[0].shape
            y = xs[0].reshape(b_, h, w_, g, c // g).permute(0, 1, 2, 4, 3) \
                .reshape(b_, h, w_, c)
            return tail(y, list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "elementwise":
        kind = p.get("ew_kind", "add")
        if kind in ("add", "sub", "maximum", "minimum"):
            def fn(*xs):
                rhs = xs[1] if n_base >= 2 else xs[0]
                return tail(_ew_rescaled(kind, xs[0], rhs), list(xs[n_base:]))
            return fn, list(node.inputs)
        if kind == "mul":
            def fn(*xs):
                rhs = xs[1] if n_base >= 2 else xs[0]
                return tail(_ew_mul(xs[0], rhs), list(xs[n_base:]))
            return fn, list(node.inputs)

        def fn(*xs):  # unary via LUT-equivalent float round trip
            return tail(_lut_roundtrip(xs[0], kind), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "activation":
        act = p.get("act", "relu")

        def fn(*xs):
            if act == "relu":
                return tail(torch.clamp_min(xs[0], 0), list(xs[n_base:]))
            return tail(_lut_roundtrip(xs[0], act), list(xs[n_base:]))
        return fn, list(node.inputs)

    raise NotImplementedError(f"quant executor: op type {t!r}")

