"""IR → executable torch callables (the profiling substrate on the card).

The twin of the reference executor (``repro.core.executor``).  Modes:

  * ``op_by_op``     — each op is a separate callable dispatched
                       sequentially (TFLite CPU interpreter semantics;
                       python dispatch overhead = the paper's T_overhead).
  * ``fused_groups`` — ops grouped by the Alg. C.1 fusion simulator; one
                       callable per group (GPU-delegate semantics; group
                       count == kernel count).  Eager torch still issues
                       the group's elementwise tail as separate launches
                       after the convolution (its bias rides in the conv).
  * ``whole_jit``    — the whole op sequence as one unit (the reference
                       jits it into one XLA executable, "upper bound").
                       On the card: one CUDA graph of the ``op_by_op``
                       program, captured per input signature and replayed,
                       so the host dispatches nothing between ops; there
                       is no fusion across ops (XLA's would).  On the
                       host: the op functions run in one call.

``dtype="int8"`` builds its ops with `repro_torch.quant.int8`: the int8
GEMM kernel carries fully-connected and dense convolution ops.  The
float ``winograd_conv2d`` op runs the Winograd kernel
(`repro_torch.kernels.winograd_conv`) on the card.

Layout: the public layout is the reference's NHWC activations and HWIO
weights.  Convolutions and pools view an NHWC tensor as NCHW with
``permute`` — a channels-last view, no copy — so cuDNN runs on the
physical NHWC layout and results come back as NHWC views.

Precision: a "float32" setting measures float32.  Building any executor
(or op) switches TF32 off for cuDNN convolutions and cuBLAS matmuls
(``torch.backends.cudnn.allow_tf32 = False``,
``torch.backends.cuda.matmul.allow_tf32 = False``); torch's default runs
float32 convolutions in TF32, which keeps ~3 decimal digits.

Weights are deterministic per op and built from the same numpy bits as
the reference (`make_array`, `_weight_seed`, `_seed_from` are verbatim
copies), then uploaded once per built op.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fusion import fuse_graph
from repro_torch.core.ir import OpGraph, OpNode, op_signature
from repro_torch.kernels import _build
from repro_torch.kernels.ops import winograd_conv2d
from repro_torch.kernels.winograd_conv import transform_weights
from repro_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Deterministic weight/input generation (verbatim from the reference)
# ---------------------------------------------------------------------------

def _seed_from(sig: str, tag: str) -> int:
    return int(hashlib.sha256(f"{sig}:{tag}".encode()).hexdigest()[:8], 16)


def _weight_seed(node: OpNode, shape: Sequence[int], tag: str) -> int:
    """Stable across fusion/selection rewrites: depends only on op identity
    and weight shape, so e.g. winograd_conv2d(op) == conv2d(op) numerically."""
    return _seed_from(f"op{node.op_id}:{tuple(shape)}", tag)


def make_array(shape: Sequence[int], dtype: str, seed: int, scale: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-64, 64, size=shape, dtype=dtype)
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _float32_only() -> None:
    """A float32 setting measures float32: no TF32 in convs or matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Per-op kernels (float path)
# ---------------------------------------------------------------------------

def _relu6(x: Tensor) -> Tensor:
    return torch.clamp(x, 0, 6)


_ACTS: Dict[str, Callable[[Tensor], Tensor]] = {
    "relu": torch.relu,
    "relu6": _relu6,
    "hswish": F.hardswish,                 # jax.nn.hard_swish: x·relu6(x+3)/6
    "swish": F.silu,                       # jax.nn.swish is SiLU
    "sigmoid": torch.sigmoid,
    "gelu": partial(F.gelu, approximate="tanh"),   # jax.nn.gelu default
    "tanh": torch.tanh,
    "identity": lambda x: x,
}

_EW_BINOPS: Dict[str, Callable[[Tensor, Tensor], Tensor]] = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "maximum": torch.maximum, "minimum": torch.minimum,
    "pow": torch.pow, "equal": lambda a, b: (a == b).to(a.dtype),
    "greater": lambda a, b: (a > b).to(a.dtype),
    "less": lambda a, b: (a < b).to(a.dtype),
}
# Domain-safe variants: split-block branches apply these to raw
# activations (paper §4.3.2), so sqrt/log guard their domain and exp is
# clipped — identical op cost, well-defined numerics.
_EW_UNOPS: Dict[str, Callable[[Tensor], Tensor]] = {
    "exp": lambda x: torch.exp(torch.clamp(x, -30.0, 30.0)),
    "log": lambda x: torch.log(torch.abs(x) + 1e-3),
    "sqrt": lambda x: torch.sqrt(torch.abs(x)),
    "square": torch.square,
    "abs": torch.abs, "neg": torch.neg, "copy": lambda x: x,
}


def _conv_weights(node: OpNode, graph: OpGraph, dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    in_c = graph.tensor(node.inputs[0]).shape[-1]
    out_c = node.param("out_c") or graph.tensor(node.outputs[0]).shape[-1]
    kh, kw = node.param("kernel_h", 1), node.param("kernel_w", 1)
    groups = node.param("groups", 1)
    if node.op_type == "dwconv2d":
        groups = in_c
    wshape = (kh, kw, in_c // groups, out_c)
    w = make_array(wshape, dtype, _weight_seed(node, wshape, "w"))
    b = make_array((out_c,), dtype, _weight_seed(node, wshape, "b"))
    return w, b


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (lo, hi): out = ceil(size/stride), odd totals
    put the extra row/column on the high side (asymmetric at stride 2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _hwio_to_oihw(w: np.ndarray, device: torch.device) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))) \
        .to(device).contiguous(memory_format=torch.channels_last)


def _conv_call(x: Tensor, w: Tensor, b: Optional[Tensor], stride: int,
               groups: int, act: Optional[str], padding: str = "SAME") -> Tensor:
    """NHWC ``x`` ⊛ OIHW ``w`` (+ b, act) → NHWC, with XLA's padding rules."""
    kh, kw = w.shape[2], w.shape[3]
    pad_hw = (0, 0)
    if padding == "SAME":
        (hl, hh) = _same_pads(x.shape[1], kh, stride)
        (wl, wh) = _same_pads(x.shape[2], kw, stride)
        if hh > hl or wh > wl:              # asymmetric: pad the extra high side
            x = F.pad(x, (0, 0, 0, wh - wl, 0, hh - hl))
        pad_hw = (hl, wl)
    elif padding != "VALID":
        raise ValueError(f"unsupported conv padding {padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=pad_hw,
                 groups=groups).permute(0, 2, 3, 1)
    if act:
        y = _ACTS[act](y)
    return y


def _pool_call(x: Tensor, k: Tuple[int, int], s: int, kind: str) -> Tensor:
    """SAME-padded NHWC pool: max pads with −inf, avg sums the zero-padded
    window and divides by k·k (padding counted, as the reference)."""
    (hl, hh) = _same_pads(x.shape[1], k[0], s)
    (wl, wh) = _same_pads(x.shape[2], k[1], s)
    fill = float("-inf") if kind == "pool_max" else 0.0
    if hl or hh or wl or wh:
        x = F.pad(x, (0, 0, wl, wh, hl, hh), value=fill)
    xc = x.permute(0, 3, 1, 2)
    if kind == "pool_max":
        y = F.max_pool2d(xc, k, stride=s)
    else:
        y = F.avg_pool2d(xc, k, stride=s, divisor_override=1) / (k[0] * k[1])
    return y.permute(0, 2, 3, 1)


def _nearest_index(m: int, n: int, device: torch.device) -> Tensor:
    """jax.image.resize "nearest" source index: floor((i + 0.5)·m / n) in
    float32 — torch's ``nearest-exact`` rule (not its legacy ``nearest``)."""
    off = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n
    return torch.floor(off).to(torch.long)


def _resize_nearest(x: Tensor, out_shape: Sequence[int]) -> Tensor:
    for d in range(1, x.dim()):
        if x.shape[d] != out_shape[d]:
            x = x.index_select(d, _nearest_index(x.shape[d], out_shape[d],
                                                 x.device))
    return x


def _apply_fused_tail(node: OpNode, y: Tensor, extras: List[Tensor]) -> Tensor:
    """Apply the element-wise ops merged into this kernel by Alg. C.1.

    Binary fused ops consume their true second operand from ``extras``
    (appended to node.inputs by the fusion pass, in merge order), so
    fused execution is numerically identical to unfused execution.
    Kinds marked ``@self`` had a duplicate reference to the producer's
    output dropped at merge time (diamond collapse); they read the
    kernel's base output instead.
    """
    it = iter(extras)
    base = y
    for kind in node.fused:
        self_ref = kind.endswith("@self")
        if self_ref:
            kind = kind[:-5]
        if kind in _EW_UNOPS:
            y = _EW_UNOPS[kind](y)
        elif kind in _EW_BINOPS:
            rhs = base if self_ref else next(it, None)
            y = _EW_BINOPS[kind](y, y * 0.5 if rhs is None else rhs)
        elif kind in _ACTS:
            y = _ACTS[kind](y)
        elif kind in ("activation", "elementwise_lm"):
            y = _ACTS["relu"](y)
    return y


def build_op_fn(graph: OpGraph, node: OpNode, device: DeviceLike = "cuda"
                ) -> Tuple[Callable, List[int]]:
    """Return (fn, input tensor ids) for one op, weights on ``device``.

    ``fn`` takes *all* of ``node.inputs`` in order: the first
    ``params['n_inputs']`` feed the base op; the rest are operands of
    fused element-wise tails (paper Alg. C.1 merges rewire them here).
    """
    dev = resolve_device(device)
    _float32_only()
    t = node.op_type
    p = node.params_dict
    n_base = p.get("n_inputs", 1)
    tail = partial(_apply_fused_tail, node)

    def upload(a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if t in ("conv2d", "grouped_conv2d"):
        w, b = _conv_weights(node, graph)
        stride = p.get("stride", 1)
        groups = p.get("groups", 1)
        act = p.get("act")
        padding = p.get("padding", "SAME")
        bt = upload(b)
        if t == "grouped_conv2d" and p.get("naive_split"):
            # Naive 3-stage grouped conv (split/conv-per-group/concat) —
            # the paper's baseline in Fig. 9.
            ws = [_hwio_to_oihw(wi, dev) for wi in np.split(w, groups, axis=3)]

            def fn(*xs):
                parts = torch.tensor_split(xs[0], groups, dim=-1)
                ys = [_conv_call(xi, wi, None, stride, 1, None)
                      for xi, wi in zip(parts, ws)]
                y = torch.cat(ys, dim=-1) + bt
                if act:
                    y = _ACTS[act](y)
                return tail(y, list(xs[n_base:]))
            return fn, list(node.inputs)

        wt = _hwio_to_oihw(w, dev)

        def fn(*xs):
            return tail(_conv_call(xs[0], wt, bt, stride, groups, act, padding),
                        list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "dwconv2d":
        w, b = _conv_weights(node, graph)
        stride, act = p.get("stride", 1), p.get("act")
        padding = p.get("padding", "SAME")
        in_c = graph.tensor(node.inputs[0]).shape[-1]
        wt, bt = _hwio_to_oihw(w, dev), upload(b)

        def fn(*xs):
            return tail(_conv_call(xs[0], wt, bt, stride, in_c, act, padding),
                        list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "winograd_conv2d":
        w, b = _conv_weights(node, graph)
        act = p.get("act")
        u = transform_weights(upload(w))                # offline: (16, C, K)
        bt = upload(b)

        def fn(*xs):
            y = winograd_conv2d(xs[0], u) + bt
            if act:
                y = _ACTS[act](y)
            return tail(y, list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "fully_connected":
        in_c = graph.tensor(node.inputs[0]).shape[-1]
        out_c = graph.tensor(node.outputs[0]).shape[-1]
        w = upload(make_array((in_c, out_c), "float32",
                              _weight_seed(node, (in_c, out_c), "w")))
        b = upload(make_array((out_c,), "float32",
                              _weight_seed(node, (in_c, out_c), "b")))
        act = p.get("act")
        out_shape = tuple(graph.tensor(node.outputs[0]).shape)

        def fn(*xs):
            y = xs[0].reshape(-1, in_c) @ w + b
            if act:
                y = _ACTS[act](y)
            return tail(y.reshape(out_shape), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "mean":
        keep = p.get("keepdims", False)

        def fn(*xs):
            return tail(torch.mean(xs[0], dim=(1, 2), keepdim=keep),
                        list(xs[n_base:]))
        return fn, list(node.inputs)

    if t in ("pool_avg", "pool_max"):
        k = (p.get("kernel_h", 1), p.get("kernel_w", 1))
        s = p.get("stride", 1)

        def fn(*xs):
            return tail(_pool_call(xs[0], k, s, t), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "concat":
        axis = p.get("axis", -1)

        def fn(*xs):
            return tail(torch.cat(xs[:n_base], dim=axis), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "split":
        n = p.get("num_splits", 2)
        axis = p.get("axis", -1)

        def fn(*xs):
            return tuple(torch.tensor_split(xs[0], n, dim=axis))
        return fn, list(node.inputs)

    if t == "pad":
        pads = p.get("paddings", ((0, 0), (1, 1), (1, 1), (0, 0)))
        # jnp.pad's per-dim (lo, hi) pairs → F.pad's last-dim-first list.
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
        if kind in _EW_UNOPS:
            def fn(*xs):
                return tail(_EW_UNOPS[kind](xs[0]), list(xs[n_base:]))
            return fn, list(node.inputs)
        if kind in _ACTS:
            def fn(*xs):
                return tail(_ACTS[kind](xs[0]), list(xs[n_base:]))
            return fn, list(node.inputs)
        if n_base >= 2:
            def fn(*xs):
                return tail(_EW_BINOPS[kind](xs[0], xs[1]), list(xs[n_base:]))
            return fn, list(node.inputs)

        def fn(*xs):
            return tail(_EW_BINOPS[kind](xs[0], xs[0]), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "activation":
        act = p.get("act", "relu")

        def fn(*xs):
            return tail(_ACTS[act](xs[0]), list(xs[n_base:]))
        return fn, list(node.inputs)

    if t == "resize":
        out_shape = graph.tensor(node.outputs[0]).shape
        method = p.get("mode", "nearest")
        if method != "nearest":
            raise NotImplementedError(f"executor: resize mode {method!r}")

        def fn(*xs):
            return tail(_resize_nearest(xs[0], out_shape), list(xs[n_base:]))
        return fn, list(node.inputs)

    raise NotImplementedError(f"executor: op type {t!r} (conv-space executor)")


def op_builder(dtype: str) -> Callable[..., Tuple[Callable, List[int]]]:
    """`build_op_fn` for float32, `repro_torch.quant.build_quant_op_fn`
    for int8."""
    if dtype == "int8":
        from repro_torch.quant.int8 import build_quant_op_fn
        return build_quant_op_fn
    return build_op_fn


# ---------------------------------------------------------------------------
# Graph executors
# ---------------------------------------------------------------------------

# Eager runs on a side stream before a capture: cuDNN picks its algorithms,
# libraries load and the allocator's pools grow outside the graph.
CAPTURE_WARMUP = 2


@lru_cache(maxsize=None)
def _capture_stream(index: int) -> "torch.cuda.Stream":
    """The one side stream of every ``whole_jit`` warm-up and capture on
    card ``index``: torch keeps a cuBLAS workspace for each stream a
    matmul has run on, so a fresh stream a capture would add one."""
    return torch.cuda.Stream(torch.device("cuda", index))


@dataclass
class WholeGraph:
    """One captured CUDA graph of a ``whole_jit`` executor: its static input
    and output buffers, the launches its capture recorded
    (`repro_torch.kernels._build.Launches`), its replays and the seconds
    the warm-up and capture took."""

    graph: Any                      # torch.cuda.CUDAGraph
    inputs: List[Tensor]
    outputs: Tuple[Tensor, ...]
    launches: _build.Launches
    capture_s: float
    replays: int = 0

    def kernel_launches(self) -> Dict[str, int]:
        """Launches of the port's kernels recorded in the graph, by kernel
        (one replay runs each of them this many times)."""
        out: Dict[str, int] = {}
        for counter, name, n in self.launches:
            if not counter.routes:
                out[name] = out.get(name, 0) + n
        return out


class GraphExecutor:
    """Execute an OpGraph on ``device`` (the card unless told otherwise).

    ``fn_cache`` (optional, signature-keyed) shares built per-op
    callables across executors — valid for *timing* (latency depends on
    the op config, not its weights), not for numerics.  ``dtype='int8'``
    uses the integer-arithmetic path (`repro_torch.quant`).

    ``whole_jit`` on the card captures, at the first call with a given
    input signature (shapes, dtypes), one `torch.cuda.CUDAGraph` of the
    ``op_by_op`` sequence into static buffers (`WholeGraph`, in
    ``whole_graphs``), after `CAPTURE_WARMUP` eager runs on a side stream.
    Every call copies its inputs into the static buffers, replays the
    graph and returns clones of the static outputs, so a later call
    overwrites nothing returned earlier.  A capture that fails raises;
    nothing runs eagerly in its place.  Each graph holds its own memory
    pool, released with the executor.  The kernels' launch counts count
    a captured launch once per replay, not at capture.
    """

    def __init__(self, graph: OpGraph, mode: str = "op_by_op",
                 dtype: str = "float32",
                 fn_cache: Optional[Dict[str, Callable]] = None,
                 device: DeviceLike = "cuda"):
        if mode not in ("op_by_op", "fused_groups", "whole_jit"):
            raise ValueError(f"unknown executor mode {mode!r}")
        if dtype not in ("float32", "int8"):
            raise ValueError(f"unknown executor dtype {dtype!r}")
        self.device = resolve_device(device)
        self.graph = graph
        self.mode = mode
        self.dtype = dtype
        self.fn_cache = fn_cache
        self.whole_graphs: Dict[tuple, WholeGraph] = {}
        self._build()

    def _build(self) -> None:
        g = self.graph
        if self.mode == "fused_groups":
            _, g = fuse_graph(self.graph)
        self.exec_graph = g
        build = op_builder(self.dtype)
        self.op_fns: List[Tuple[OpNode, Callable, List[int]]] = []
        for node in g.nodes:
            if self.fn_cache is not None:
                sig = self.dtype + ":" + op_signature(g, node)
                fn = self.fn_cache.get(sig)
                if fn is None:
                    fn, in_ids = build(g, node, self.device)
                    self.fn_cache[sig] = fn
                else:
                    in_ids = list(node.inputs)
            else:
                fn, in_ids = build(g, node, self.device)
            self.op_fns.append((node, fn, in_ids))

    def example_inputs(self, seed: int = 0) -> List[Tensor]:
        dtype = "int8" if self.dtype == "int8" else None
        return [
            torch.from_numpy(make_array(self.exec_graph.tensor(t).shape,
                                        dtype or self.exec_graph.tensor(t).dtype,
                                        seed + i, scale=1.0)).to(self.device)
            for i, t in enumerate(self.exec_graph.input_ids)
        ]

    def __call__(self, *inputs: Tensor, sync_per_op: bool = False) -> Tuple[Tensor, ...]:
        """Run the graph.

        ``sync_per_op=True`` blocks after every op — TFLite-CPU-interpreter
        semantics (ops strictly sequential).  False leaves the CUDA stream
        free to queue launches ahead — the GPU-command-queue analogue.
        ``whole_jit`` ignores it, as the reference does.
        """
        if self.mode == "whole_jit":
            if self.device.type == "cuda":
                return self._replay(inputs)
            return self._run(inputs, sync=False)
        return self._run(inputs, sync=sync_per_op and self.device.type == "cuda")

    def _run(self, inputs: Sequence[Tensor], sync: bool) -> Tuple[Tensor, ...]:
        g = self.exec_graph
        env: Dict[int, Tensor] = dict(zip(g.input_ids, inputs))
        for node, fn, in_ids in self.op_fns:
            outs = fn(*[env[t] for t in in_ids])
            if not isinstance(outs, tuple):
                outs = (outs,)
            if sync:
                torch.cuda.synchronize(self.device)
            for tid, o in zip(node.outputs, outs):
                env[tid] = o
        return tuple(env[t] for t in g.output_ids)

    def _replay(self, inputs: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        with torch.cuda.device(self.device):
            whole = self.whole_graphs.get(key)
            if whole is None:
                whole = self.whole_graphs[key] = self._capture(inputs)
            for buf, x in zip(whole.inputs, inputs):
                buf.copy_(x)
            whole.graph.replay()
            _build.add_launches(whole.launches)
            whole.replays += 1
            return tuple(o.clone() for o in whole.outputs)

    def _capture(self, inputs: Sequence[Tensor]) -> WholeGraph:
        """Warm up on a side stream, then capture the op sequence into one
        CUDA graph (kept as a template too: ``raw_cuda_graph()``)."""
        t0 = time.perf_counter()
        static_in = [x.detach().clone() for x in inputs]
        side = _capture_stream(self.device.index)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                self._run(static_in, sync=False)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        launches: _build.Launches = []
        try:
            with _build.capturing_launches(launches):
                with torch.cuda.graph(graph, stream=side):
                    static_out = self._run(static_in, sync=False)
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"whole_jit: capturing {self.graph.name!r} as one "
                               f"CUDA graph failed: {e}") from e
        torch.cuda.synchronize(self.device)
        return WholeGraph(graph, static_in, static_out, launches,
                          time.perf_counter() - t0)

    def kernel_count(self) -> int:
        return 1 if self.mode == "whole_jit" else len(self.op_fns)
