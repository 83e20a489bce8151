"""Per-operation feature extraction (paper Table 3 + LM extensions).

Each op type has a fixed-order feature vector combining shape parameters
with memory-cost features (input/output/parameter sizes) and compute-cost
features (FLOPs), exactly mirroring paper Table 3:

  Conv2D/Winograd/DepthwiseConv2D: input h/w, in_ch, output h/w, stride,
      kernel h/w, filters, input size, output size, kernel size, FLOPs
  GroupedConv2D: + group number
  FullyConnected: in_ch, filters, parameter size, FLOPs
  Mean: input h/w, in_ch, kernel h/w, input size, FLOPs
  Concat/Split: input h/w, in_ch, kernel h/w, out_ch, input size, output size
  Pooling: input h/w, in_ch, output h/w, stride, kernel h/w, in/out size, FLOPs
  Padding: input h/w, in_ch, output h/w, padding size, output size
  Element-wise: input h/w, in_ch, input size

LM-family op types get analogous (shape, bytes, flops) features so the
same predictor machinery covers transformer/SSM/MoE graphs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.ir import OpGraph, OpNode
from repro_torch.utils.lru import SegmentedLRUCache

FeatureFn = Callable[[OpGraph, OpNode], Tuple[List[str], List[float]]]

_FEATURIZERS: Dict[str, FeatureFn] = {}


def register_featurizer(op_type: str):
    def deco(fn: FeatureFn) -> FeatureFn:
        _FEATURIZERS[op_type] = fn
        return fn

    return deco


def featurize(graph: OpGraph, node: OpNode) -> Tuple[List[str], np.ndarray]:
    """Return (feature_names, feature_vector) for one op."""
    fn = _FEATURIZERS.get(node.op_type)
    if fn is None:
        raise KeyError(f"no featurizer for op type {node.op_type!r}")
    names, vals = fn(graph, node)
    return names, np.asarray(vals, dtype=np.float64)


def feature_names(op_type: str) -> List[str]:
    """Feature names for an op type (probe with a dummy — featurizers are pure).

    Names are static per featurizer, so they are derived lazily: the
    first access for an op type runs its featurizer on a dummy probe
    node.  (Indexing `_NAME_CACHE` directly raised `KeyError` for any
    type that had never been featurized in-process.)
    """
    if op_type not in _NAME_CACHE:
        _probe_names(op_type)
    return list(_NAME_CACHE[op_type])


_NAME_CACHE: Dict[str, List[str]] = {}


def _cache_names(op_type: str, names: List[str]) -> None:
    if op_type not in _NAME_CACHE:
        _NAME_CACHE[op_type] = list(names)


def _probe_names(op_type: str) -> None:
    """Run ``op_type``'s featurizer on a dummy node to populate the cache.

    Every featurizer only reads input/output tensor shapes and node
    params (all of which have defaults), so a generic one-in/one-out
    NHWC probe covers the whole registry.
    """
    fn = _FEATURIZERS.get(op_type)
    if fn is None:
        raise KeyError(f"no featurizer for op type {op_type!r}")
    g = OpGraph(f"__probe_{op_type}")
    tin = g.add_tensor((1, 8, 8, 4))
    tout = g.add_tensor((1, 8, 8, 4))
    node = OpNode(op_id=0, op_type=op_type, inputs=(tin,), outputs=(tout,))
    fn(g, node)    # registered wrappers call _cache_names themselves


# ---------------------------------------------------------------------------
# FLOP helpers (multiply-accumulate counted as 2 FLOPs, per common convention)
# ---------------------------------------------------------------------------

def conv_flops(out_h: int, out_w: int, out_c: int, k_h: int, k_w: int,
               in_c_per_group: int, batch: int = 1) -> float:
    return 2.0 * batch * out_h * out_w * out_c * k_h * k_w * in_c_per_group


# Cost tiers for activation / element-wise kinds.  The paper's Table 3
# omits these because TFLite fuses cheap activations into convs; on
# XLA:CPU a transcendental activation on a large tensor has measurable
# cost, so we expose a coarse tier feature (extension, see DESIGN.md §8).
_KIND_COST = {
    None: 0.0, "": 0.0, "identity": 0.0, "copy": 0.0, "neg": 0.5, "abs": 0.5,
    "relu": 1.0, "relu6": 1.0, "add": 1.0, "sub": 1.0, "maximum": 1.0,
    "minimum": 1.0, "square": 1.0, "mul": 1.0, "greater": 1.0, "less": 1.0,
    "equal": 1.0, "hswish": 2.0, "sqrt": 2.0, "div": 2.0,
    "sigmoid": 3.0, "swish": 3.0, "exp": 3.0, "log": 3.0, "pow": 3.0,
    "tanh": 3.0, "gelu": 3.0,
}


def kind_cost(kind) -> float:
    # "@self" marks a duplicate-operand fused kind (fusion diamond
    # collapse); the arithmetic — and therefore the cost — is unchanged.
    if isinstance(kind, str) and "@" in kind:
        kind = kind.split("@", 1)[0]
    return _KIND_COST.get(kind, 1.5)


def _fused_tail_features(node: OpNode) -> Tuple[List[str], List[float]]:
    """Features of element-wise ops merged into this kernel (Alg. C.1)."""
    n = float(len(node.fused))
    cost = float(sum(kind_cost(k) for k in node.fused))
    return ["n_fused", "fused_cost"], [n, cost]


def _hw(shape: Tuple[int, ...]) -> Tuple[int, int, int, int]:
    """Return (batch, H, W, C) from an NHWC shape."""
    if len(shape) == 4:
        return shape[0], shape[1], shape[2], shape[3]
    if len(shape) == 3:
        return 1, shape[0], shape[1], shape[2]
    if len(shape) == 2:
        return shape[0], 1, 1, shape[1]
    raise ValueError(f"unsupported shape {shape}")


# ---------------------------------------------------------------------------
# Conv-family featurizers (paper Table 3, row 1-2)
# ---------------------------------------------------------------------------

def _conv_features(graph: OpGraph, node: OpNode, grouped: bool):
    x = graph.tensor(node.inputs[0])
    y = graph.tensor(node.outputs[0])
    _, ih, iw, ic = _hw(x.shape)
    _, oh, ow, oc = _hw(y.shape)
    kh = node.param("kernel_h", 1)
    kw = node.param("kernel_w", 1)
    stride = node.param("stride", 1)
    groups = node.param("groups", 1)
    if node.op_type == "dwconv2d":
        groups = ic
    in_c_per_group = max(1, ic // max(1, groups))
    filters = oc
    input_size = x.size
    output_size = y.size
    kernel_size = kh * kw * in_c_per_group * oc
    flops = conv_flops(oh, ow, oc, kh, kw, in_c_per_group)
    names = [
        "input_h", "input_w", "input_c", "output_h", "output_w", "stride",
        "kernel_h", "kernel_w", "filters", "input_size", "output_size",
        "kernel_size", "flops",
    ]
    vals = [ih, iw, ic, oh, ow, stride, kh, kw, filters, input_size,
            output_size, kernel_size, flops]
    if grouped:
        names.append("groups")
        vals.append(groups)
    # Activation tier + fused-tail features (extensions, DESIGN.md §8).
    act = node.param("act")
    names += ["act_cost"]
    vals += [kind_cost(act)]
    fn, fv = _fused_tail_features(node)
    names += fn
    vals += fv
    return names, vals


@register_featurizer("conv2d")
def _f_conv2d(graph, node):
    names, vals = _conv_features(graph, node, grouped=False)
    _cache_names("conv2d", names)
    return names, vals


@register_featurizer("winograd_conv2d")
def _f_winograd(graph, node):
    names, vals = _conv_features(graph, node, grouped=False)
    _cache_names("winograd_conv2d", names)
    return names, vals


@register_featurizer("dwconv2d")
def _f_dwconv(graph, node):
    names, vals = _conv_features(graph, node, grouped=False)
    _cache_names("dwconv2d", names)
    return names, vals


@register_featurizer("grouped_conv2d")
def _f_grouped(graph, node):
    names, vals = _conv_features(graph, node, grouped=True)
    _cache_names("grouped_conv2d", names)
    return names, vals


@register_featurizer("fully_connected")
def _f_fc(graph, node):
    x = graph.tensor(node.inputs[0])
    y = graph.tensor(node.outputs[0])
    in_c = x.shape[-1]
    filters = y.shape[-1]
    batch = int(x.size // max(1, in_c))
    param_size = in_c * filters + filters
    flops = 2.0 * batch * in_c * filters
    names = ["input_c", "filters", "param_size", "flops", "act_cost"]
    vals = [in_c, filters, param_size, flops, kind_cost(node.param("act"))]
    fn, fv = _fused_tail_features(node)
    _cache_names("fully_connected", names + fn)
    return names + fn, vals + fv


@register_featurizer("mean")
def _f_mean(graph, node):
    x = graph.tensor(node.inputs[0])
    _, ih, iw, ic = _hw(x.shape)
    kh = node.param("kernel_h", ih)
    kw = node.param("kernel_w", iw)
    flops = float(x.size)
    names = ["input_h", "input_w", "input_c", "kernel_h", "kernel_w",
             "input_size", "flops"]
    _cache_names("mean", names)
    return names, [ih, iw, ic, kh, kw, x.size, flops]


def _concat_split_features(graph: OpGraph, node: OpNode):
    x = graph.tensor(node.inputs[0])
    _, ih, iw, ic = _hw(x.shape)
    out_c = sum(graph.tensor(t).shape[-1] for t in node.outputs)
    input_size = sum(graph.tensor(t).size for t in node.inputs)
    output_size = sum(graph.tensor(t).size for t in node.outputs)
    names = ["input_h", "input_w", "input_c", "kernel_h", "kernel_w",
             "output_c", "input_size", "output_size"]
    return names, [ih, iw, ic, 1, 1, out_c, input_size, output_size]


@register_featurizer("concat")
def _f_concat(graph, node):
    names, vals = _concat_split_features(graph, node)
    _cache_names("concat", names)
    return names, vals


@register_featurizer("split")
def _f_split(graph, node):
    names, vals = _concat_split_features(graph, node)
    _cache_names("split", names)
    return names, vals


@register_featurizer("channel_shuffle")
def _f_shuffle(graph, node):
    names, vals = _concat_split_features(graph, node)
    _cache_names("channel_shuffle", names)
    return names, vals


def _pool_features(graph: OpGraph, node: OpNode):
    x = graph.tensor(node.inputs[0])
    y = graph.tensor(node.outputs[0])
    _, ih, iw, ic = _hw(x.shape)
    _, oh, ow, _ = _hw(y.shape)
    kh = node.param("kernel_h", 1)
    kw = node.param("kernel_w", 1)
    stride = node.param("stride", 1)
    flops = float(y.size) * kh * kw
    names = ["input_h", "input_w", "input_c", "output_h", "output_w",
             "stride", "kernel_h", "kernel_w", "input_size", "output_size",
             "flops"]
    return names, [ih, iw, ic, oh, ow, stride, kh, kw, x.size, y.size, flops]


@register_featurizer("pool_avg")
def _f_pool_avg(graph, node):
    names, vals = _pool_features(graph, node)
    _cache_names("pool_avg", names)
    return names, vals


@register_featurizer("pool_max")
def _f_pool_max(graph, node):
    names, vals = _pool_features(graph, node)
    _cache_names("pool_max", names)
    return names, vals


@register_featurizer("resize")
def _f_resize(graph, node):
    x = graph.tensor(node.inputs[0])
    y = graph.tensor(node.outputs[0])
    _, ih, iw, ic = _hw(x.shape)
    _, oh, ow, _ = _hw(y.shape)
    scale = float(oh) / float(max(1, ih))
    names = ["input_h", "input_w", "input_c", "output_h", "output_w",
             "scale", "input_size", "output_size"]
    _cache_names("resize", names)
    return names, [ih, iw, ic, oh, ow, scale, x.size, y.size]


@register_featurizer("pad")
def _f_pad(graph, node):
    x = graph.tensor(node.inputs[0])
    y = graph.tensor(node.outputs[0])
    _, ih, iw, ic = _hw(x.shape)
    _, oh, ow, _ = _hw(y.shape)
    pad_size = y.size - x.size
    names = ["input_h", "input_w", "input_c", "output_h", "output_w",
             "pad_size", "output_size"]
    _cache_names("pad", names)
    return names, [ih, iw, ic, oh, ow, pad_size, y.size]


@register_featurizer("elementwise")
def _f_elementwise(graph, node):
    x = graph.tensor(node.inputs[0])
    _, ih, iw, ic = _hw(x.shape)
    names = ["input_h", "input_w", "input_c", "input_size", "kind_cost", "n_operands"]
    _cache_names("elementwise", names)
    return names, [ih, iw, ic, x.size, kind_cost(node.param("ew_kind", "add")),
                   float(node.param("n_inputs", 1))]


@register_featurizer("activation")
def _f_activation(graph, node):
    x = graph.tensor(node.inputs[0])
    _, ih, iw, ic = _hw(x.shape)
    names = ["input_h", "input_w", "input_c", "input_size", "kind_cost"]
    _cache_names("activation", names)
    return names, [ih, iw, ic, x.size, kind_cost(node.param("act", "relu"))]


# ---------------------------------------------------------------------------
# LM-family featurizers (TPU extension): (shape dims, bytes, flops)
# ---------------------------------------------------------------------------

def _bytes_of(graph: OpGraph, tids) -> float:
    return float(sum(graph.tensor(t).nbytes for t in tids))


@register_featurizer("matmul")
def _f_matmul(graph, node):
    m = node.param("m", 1)
    n = node.param("n", 1)
    k = node.param("k", 1)
    b = node.param("batch", 1)
    flops = 2.0 * b * m * n * k
    in_b = _bytes_of(graph, node.inputs)
    out_b = _bytes_of(graph, node.outputs)
    names = ["m", "n", "k", "batch", "input_bytes", "output_bytes", "flops"]
    _cache_names("matmul", names)
    return names, [m, n, k, b, in_b, out_b, flops]


def _attn_features(graph: OpGraph, node: OpNode):
    b = node.param("batch", 1)
    q_len = node.param("q_len", 1)
    kv_len = node.param("kv_len", 1)
    heads = node.param("heads", 1)
    kv_heads = node.param("kv_heads", heads)
    head_dim = node.param("head_dim", 64)
    window = node.param("window", 0) or kv_len
    eff_kv = min(kv_len, window)
    flops = 4.0 * b * heads * q_len * eff_kv * head_dim
    kv_bytes = 2.0 * b * kv_heads * eff_kv * head_dim * 2  # bf16 K+V
    names = ["batch", "q_len", "kv_len", "heads", "kv_heads", "head_dim",
             "window", "kv_bytes", "flops"]
    return names, [b, q_len, kv_len, heads, kv_heads, head_dim, window,
                   kv_bytes, flops]


@register_featurizer("attention")
def _f_attention(graph, node):
    names, vals = _attn_features(graph, node)
    _cache_names("attention", names)
    return names, vals


@register_featurizer("flash_attention")
def _f_flash(graph, node):
    names, vals = _attn_features(graph, node)
    _cache_names("flash_attention", names)
    return names, vals


@register_featurizer("window_attention")
def _f_window(graph, node):
    names, vals = _attn_features(graph, node)
    _cache_names("window_attention", names)
    return names, vals


@register_featurizer("norm")
def _f_norm(graph, node):
    x = graph.tensor(node.inputs[0])
    names = ["size", "width", "flops"]
    _cache_names("norm", names)
    return names, [x.size, x.shape[-1], 5.0 * x.size]


@register_featurizer("rope")
def _f_rope(graph, node):
    x = graph.tensor(node.inputs[0])
    names = ["size", "flops"]
    _cache_names("rope", names)
    return names, [x.size, 6.0 * x.size]


@register_featurizer("embedding")
def _f_embedding(graph, node):
    vocab = node.param("vocab", 1)
    width = node.param("width", 1)
    tokens = node.param("tokens", 1)
    names = ["vocab", "width", "tokens", "gather_bytes"]
    _cache_names("embedding", names)
    return names, [vocab, width, tokens, 2.0 * tokens * width]


@register_featurizer("softmax_xent")
def _f_xent(graph, node):
    x = graph.tensor(node.inputs[0])
    names = ["size", "vocab", "flops"]
    _cache_names("softmax_xent", names)
    return names, [x.size, x.shape[-1], 5.0 * x.size]


@register_featurizer("moe_gmm")
def _f_moe(graph, node):
    experts = node.param("experts", 1)
    top_k = node.param("top_k", 1)
    tokens = node.param("tokens", 1)
    d_model = node.param("d_model", 1)
    d_ff = node.param("d_ff", 1)
    capacity = node.param("capacity", tokens * top_k // max(1, experts))
    flops = 2.0 * 3 * experts * capacity * d_model * d_ff  # gate/up/down
    names = ["experts", "top_k", "tokens", "d_model", "d_ff", "capacity", "flops"]
    _cache_names("moe_gmm", names)
    return names, [experts, top_k, tokens, d_model, d_ff, capacity, flops]


@register_featurizer("ssd_scan")
def _f_ssd(graph, node):
    b = node.param("batch", 1)
    seq = node.param("seq", 1)
    heads = node.param("heads", 1)
    head_dim = node.param("head_dim", 1)
    state = node.param("state", 1)
    flops = 6.0 * b * seq * heads * head_dim * state
    names = ["batch", "seq", "heads", "head_dim", "state", "flops"]
    _cache_names("ssd_scan", names)
    return names, [b, seq, heads, head_dim, state, flops]


@register_featurizer("elementwise_lm")
def _f_ew_lm(graph, node):
    x = graph.tensor(node.inputs[0])
    names = ["size", "width"]
    _cache_names("elementwise_lm", names)
    return names, [x.size, x.shape[-1]]


@register_featurizer("collective")
def _f_collective(graph, node):
    nbytes = node.param("bytes", 0)
    participants = node.param("participants", 1)
    names = ["bytes", "participants"]
    _cache_names("collective", names)
    return names, [nbytes, participants]


# ---------------------------------------------------------------------------
# Whole-graph feature matrices (the prediction fast path's feature cache)
# ---------------------------------------------------------------------------

class GraphFeatures:
    """Every op of one graph featurized once, grouped by op type.

    ``matrix[op_type]`` is the (count, dim) float64 feature matrix for
    all nodes of that type (rows in node order); ``index[op_type]``
    holds their node indices, and ``slots[k] = (op_type, row)`` maps a
    node index back to its matrix row.  Per-type predictors consume the
    matrices directly — no per-node re-featurization anywhere on the
    query, training-assembly, or profiling paths.
    """

    __slots__ = ("fingerprint", "num_nodes", "matrix", "names", "index",
                 "slots", "_matrix32")

    def __init__(self, fingerprint: str, num_nodes: int,
                 matrix: Dict[str, np.ndarray], names: Dict[str, List[str]],
                 index: Dict[str, np.ndarray],
                 slots: List[Tuple[str, int]]):
        self.fingerprint = fingerprint
        self.num_nodes = num_nodes
        self.matrix = matrix
        self.names = names
        self.index = index
        self.slots = slots
        self._matrix32: Dict[str, np.ndarray] = {}

    @classmethod
    def from_graph(cls, graph: OpGraph) -> "GraphFeatures":
        rows: Dict[str, List[np.ndarray]] = {}
        names: Dict[str, List[str]] = {}
        index: Dict[str, List[int]] = {}
        slots: List[Tuple[str, int]] = []
        for k, node in enumerate(graph.nodes):
            t = node.op_type
            nm, x = featurize(graph, node)
            if t not in names:
                names[t] = list(nm)
            slots.append((t, len(rows.setdefault(t, []))))
            rows[t].append(x)
            index.setdefault(t, []).append(k)
        matrix = {t: np.stack(v) for t, v in rows.items()}
        idx = {t: np.asarray(v, dtype=np.intp) for t, v in index.items()}
        return cls(graph.fingerprint(), len(graph.nodes), matrix, names, idx, slots)

    def matrix32(self, op_type: str) -> np.ndarray:
        """Float32 view of ``matrix[op_type]`` for the device-resident
        scoring path (cast once per GraphFeatures, cached — the
        fingerprint LRU then amortizes it across flushes like the f64
        matrices).  The float64 originals stay authoritative for the
        bit-exact numpy backend."""
        m32 = self._matrix32.get(op_type)
        if m32 is None:
            m32 = np.ascontiguousarray(self.matrix[op_type], dtype=np.float32)
            self._matrix32[op_type] = m32
        return m32

    def node_features(self, k: int) -> np.ndarray:
        """Feature vector of node ``k`` (a view into its type matrix)."""
        t, row = self.slots[k]
        return self.matrix[t][row]

    def node_names(self, k: int) -> List[str]:
        return self.names[self.slots[k][0]]


# Segmented (scan-resistant) cache: search loops featurizing thousands
# of one-shot candidate fingerprints only recycle the probation segment;
# profiled/training graphs are pinned into the protected segment
# (``pin=True`` below) and survive the scan.
_GRAPH_FEATURE_CACHE = SegmentedLRUCache(probation=256, protected=256)


def graph_features(graph: OpGraph, *, cache: bool = True,
                   pin: bool = False) -> GraphFeatures:
    """`GraphFeatures` for ``graph``, LRU-cached by graph fingerprint.

    NAS re-scoring, bank training, and profiling all hit this cache, so
    a known graph is featurized exactly once per process (per cache
    window).  ``fingerprint()`` carries its own staleness guard, so
    builder-style mutations after caching get a fresh entry.

    ``pin=True`` marks the graph long-lived (profiling and training
    paths): its entry goes to the cache's protected segment, where
    population-scale scoring of one-shot candidates cannot evict it.
    """
    if not cache:
        return GraphFeatures.from_graph(graph)
    fp = graph.fingerprint()
    gf = _GRAPH_FEATURE_CACHE.get(fp)
    if gf is None or gf.num_nodes != len(graph.nodes):
        gf = GraphFeatures.from_graph(graph)
        _GRAPH_FEATURE_CACHE.put(fp, gf, protect=pin)
    elif pin:
        _GRAPH_FEATURE_CACHE.put(fp, gf, protect=True)   # upgrade in place
    return gf


def graph_feature_cache_info() -> Dict[str, int]:
    return dict(_GRAPH_FEATURE_CACHE.info())


def clear_graph_feature_cache() -> None:
    _GRAPH_FEATURE_CACHE.clear()
