"""Synthetic NAS space for the training dataset (paper §4.3.2, Fig. 12).

Architectures: 9 building blocks; width/height halves after blocks
1, 3, 5, 7, 9; then a 1×1 conv, global mean, and an FC to 1000 classes.
Block types chosen uniformly at random:

  (1) convolution (k ∈ {3,5,7}; optionally grouped, group count 4k,
      1 ≤ k ≤ 16, restricted to divisors of in/out channels);
  (2) depthwise-separable convolution (k ∈ {3,5,7});
  (3) linear bottleneck (k ∈ {3,5,7}, expansion ∈ {1,3,6},
      optional Squeeze-and-Excite);
  (4) average or max pooling (pool size ∈ {1,3}), with a 1×1 projection
      when the sampled output channels differ from the input's (pooling
      alone cannot realize the sampled Cᵢ; noted deviation);
  (5) split (2, 3 or 4) → element-wise op per branch → concat (output
      channels = input channels for divisibility; noted deviation).

Output channels: C₁–C₅ ~ U[8,80], C₆–C₉ ~ U[80,400], C₁₀ ~ U[1200,1800]
(scaled by ``channel_scale`` to fit the 1-core CPU measurement budget;
the paper measures on phones at 224×224 — we default to 32×32).

Stride-2 convolutions emit an explicit `pad` op + VALID conv with
probability 0.5, mirroring TFLite graph exports (and populating the
paper's `Padding` op category).

The space is *parameterized*: every random decision lives in a
`BlockGene`, and an architecture is a `Genotype` (one gene per block +
head width).  `sample_genotype` draws a genotype (the paper's uniform
distribution); `decode_genotype` deterministically builds its `OpGraph`.
Search layers (`repro.search`) mutate and recombine genotypes directly
— `sample_architecture` is just sample + decode and produces, seed for
seed, the graphs the sample-only path always produced.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir import OpGraph

EW_KINDS = ("abs", "square", "sqrt", "exp", "neg")
ACTS = ("relu", "relu6", "hswish")
BLOCK_KINDS = ("conv", "dwsep", "bottleneck", "pool", "split")
# Paper Fig. 12 channel ranges: C1..C5, C6..C9, and the head C10.
# Shared with `repro.search.encoding` so sampling and mutation draw
# from the same distribution.
STAGE_CHANNEL_RANGES = ((8, 80), (80, 400))
HEAD_CHANNEL_RANGE = (1200, 1800)


@dataclass
class NASSpaceConfig:
    resolution: int = 32
    num_blocks: int = 9
    halve_after: Tuple[int, ...] = (1, 3, 5, 7, 9)   # 1-indexed block ids
    channel_scale: float = 1.0
    classes: int = 1000
    explicit_pad_prob: float = 0.5


def _cdiv(a: int, b: int) -> int:
    return max(1, (a + b - 1) // b)


def _rint(rng: np.random.Generator, lo: int, hi: int, scale: float) -> int:
    v = int(rng.integers(lo, hi + 1))
    return max(4, int(round(v * scale)))


# ---------------------------------------------------------------------------
# Genotype: one gene per block (the unit search mutates)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockGene:
    """Every decision one block embodies.

    Fields beyond a kind's needs stay at their defaults (canonical form —
    `repro.search.encoding.repair` enforces it after mutation), so equal
    decoded graphs come from equal genes.  ``n_splits == 0`` on a
    ``split`` gene means the conv fallback (input channels had no
    divisor in {2,3,4}); the conv fields then apply.
    """

    kind: str                         # one of BLOCK_KINDS
    out_c: int
    kernel: int = 3                   # conv/dwsep/bottleneck (pool: {1,3})
    groups: int = 1                   # conv only
    act: str = "relu"                 # conv only
    explicit_pad: bool = False        # conv at stride 2 only
    expansion: int = 1                # bottleneck only
    use_se: bool = False              # bottleneck only
    pool_kind: str = "pool_avg"       # pool only
    n_splits: int = 0                 # split only (0 = conv fallback)
    ew_kinds: Tuple[str, ...] = ()    # split only, one per branch
    depth: int = 1                    # elastic repeat count (OFA-style)

    def to_json(self) -> Dict[str, Any]:
        d = {
            "kind": self.kind, "out_c": self.out_c, "kernel": self.kernel,
            "groups": self.groups, "act": self.act,
            "explicit_pad": self.explicit_pad, "expansion": self.expansion,
            "use_se": self.use_se, "pool_kind": self.pool_kind,
            "n_splits": self.n_splits, "ew_kinds": list(self.ew_kinds),
        }
        if self.depth != 1:
            # Emitted only when non-default so pre-elastic genotype digests
            # (and every checkpoint/golden keyed on them) stay byte-stable.
            d["depth"] = self.depth
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "BlockGene":
        d = dict(d)
        d["ew_kinds"] = tuple(d.get("ew_kinds", ()))
        return cls(**d)


@dataclass(frozen=True)
class Genotype:
    """One architecture of the space: block genes + head width.

    ``family`` distinguishes the plain block space ("block") from the
    elastic space ("elastic" — same genes, searched through shrink/grow
    knob steps and scored by the weight-sharing supernet objective).
    """

    blocks: Tuple[BlockGene, ...]
    head_c: int
    family: str = "block"

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"blocks": [b.to_json() for b in self.blocks],
                             "head_c": self.head_c}
        if self.family != "block":
            d["family"] = self.family
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Genotype":
        return cls(tuple(BlockGene.from_json(b) for b in d["blocks"]),
                   int(d["head_c"]), family=str(d.get("family", "block")))

    def digest(self) -> str:
        """Content hash — the identity search loops key populations on."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def replace_block(self, i: int, gene: BlockGene) -> "Genotype":
        blocks = list(self.blocks)
        blocks[i] = gene
        return replace(self, blocks=tuple(blocks))


# ---------------------------------------------------------------------------
# Sampling (paper's uniform draw — rng order matches the historical
# sample-only implementation, so seeds reproduce the same graphs)
# ---------------------------------------------------------------------------

def _sample_conv_gene(rng: np.random.Generator, in_c: int, out_c: int,
                      stride: int, cfg: NASSpaceConfig) -> BlockGene:
    k = int(rng.choice([3, 5, 7]))
    groups = 1
    if rng.random() < 0.3:  # "optionally grouped"
        cand = [4 * i for i in range(1, 17)
                if in_c % (4 * i) == 0 and out_c % (4 * i) == 0]
        if cand:
            groups = int(rng.choice(cand))
    explicit_pad = bool(stride == 2 and rng.random() < cfg.explicit_pad_prob)
    act = str(rng.choice(ACTS))
    return BlockGene("conv", out_c, kernel=k, groups=groups, act=act,
                     explicit_pad=explicit_pad)


def _sample_gene(rng: np.random.Generator, kind: str, in_c: int, out_c: int,
                 stride: int, cfg: NASSpaceConfig) -> BlockGene:
    if kind == "conv":
        return _sample_conv_gene(rng, in_c, out_c, stride, cfg)
    if kind == "dwsep":
        return BlockGene("dwsep", out_c, kernel=int(rng.choice([3, 5, 7])))
    if kind == "bottleneck":
        return BlockGene(
            "bottleneck", out_c, kernel=int(rng.choice([3, 5, 7])),
            expansion=int(rng.choice([1, 3, 6])),
            use_se=bool(rng.random() < 0.5))
    if kind == "pool":
        return BlockGene(
            "pool", out_c, kernel=int(rng.choice([1, 3])),
            pool_kind="pool_avg" if rng.random() < 0.5 else "pool_max")
    if kind == "split":
        divisors = [n for n in (2, 3, 4) if in_c % n == 0]
        if not divisors:
            # Conv fallback (stride already spent on the pre-pool): keep
            # the conv fields on the split gene, n_splits = 0.
            cg = _sample_conv_gene(rng, in_c, out_c, 1, cfg)
            return replace(cg, kind="split", n_splits=0)
        n = int(rng.choice(divisors))
        kinds = tuple(str(rng.choice(EW_KINDS)) for _ in range(n))
        return BlockGene("split", out_c, n_splits=n, ew_kinds=kinds)
    raise ValueError(f"unknown block kind {kind!r}")


def genotype_from_rng(rng: np.random.Generator,
                      cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """Draw one genotype from the paper's distribution (Fig. 12)."""
    cfg = cfg or NASSpaceConfig()
    # Per paper Fig. 12: C1..C5 ~ U[8,80], C6..C9 ~ U[80,400].
    chans = [
        _rint(rng, *STAGE_CHANNEL_RANGES[0], cfg.channel_scale)
        for _ in range(5)
    ] + [
        _rint(rng, *STAGE_CHANNEL_RANGES[1], cfg.channel_scale)
        for _ in range(4)
    ]
    genes: List[BlockGene] = []
    in_c = 3
    for i in range(cfg.num_blocks):
        stride = 2 if (i + 1) in cfg.halve_after else 1
        kind = BLOCK_KINDS[int(rng.integers(0, len(BLOCK_KINDS)))]
        genes.append(_sample_gene(rng, kind, in_c, chans[i], stride, cfg))
        in_c = chans[i]
    head_c = _rint(rng, *HEAD_CHANNEL_RANGE, cfg.channel_scale)
    return Genotype(tuple(genes), head_c)


def sample_genotype(seed: int,
                    cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """Genotype of the architecture `sample_architecture(seed)` builds."""
    return genotype_from_rng(np.random.default_rng(seed), cfg)


# ---------------------------------------------------------------------------
# Decoding (pure: genotype → OpGraph; invalid genes repair deterministically)
# ---------------------------------------------------------------------------

def _emit_pad(g: OpGraph, x: int, k: int) -> Tuple[int, str]:
    """Explicit pad (stride-2 TFLite style); return (tensor, padding)."""
    shape = g.tensor(x).shape
    h, w = shape[1], shape[2]
    pad_total = max(k - 2, 0)
    if h + pad_total < k or w + pad_total < k:
        return x, "SAME"   # kernel would not fit the padded map
    lo, hi = pad_total // 2, pad_total - pad_total // 2
    if pad_total == 0:
        return x, "VALID"
    (y,) = g.add_op(
        "pad", [x],
        [(shape[0], h + pad_total, w + pad_total, shape[3])],
        {"paddings": ((0, 0), (lo, hi), (lo, hi), (0, 0))},
    )
    return y, "VALID"


def _valid_groups(groups: int, in_c: int, out_c: int) -> int:
    """Group count if it divides both channel counts, else 1 (gene repair
    for crossover/mutation products; sampled genes always pass)."""
    if groups > 1 and in_c % groups == 0 and out_c % groups == 0:
        return groups
    return 1


def _build_conv(g: OpGraph, x: int, gene: BlockGene, stride: int,
                cfg: NASSpaceConfig) -> int:
    shape = g.tensor(x).shape
    in_c = shape[-1]
    k = gene.kernel
    groups = _valid_groups(gene.groups, in_c, gene.out_c)
    padding = "SAME"
    if stride == 2 and gene.explicit_pad:
        x, padding = _emit_pad(g, x, k)
        shape = g.tensor(x).shape
    oh = _cdiv(shape[1], stride) if padding != "VALID" else max(1, (shape[1] - k) // stride + 1)
    ow = _cdiv(shape[2], stride) if padding != "VALID" else max(1, (shape[2] - k) // stride + 1)
    op = "grouped_conv2d" if groups > 1 else "conv2d"
    # relu/relu6 are converter-fused into the conv (TFLite behaviour);
    # composite activations (hswish) stay separate graph nodes and are
    # candidates for Alg. C.1 fusion on GPU-class devices.
    conv_act = gene.act if gene.act in ("relu", "relu6") else None
    (y,) = g.add_op(
        op, [x], [(shape[0], oh, ow, gene.out_c)],
        {"kernel_h": k, "kernel_w": k, "stride": stride, "groups": groups,
         "act": conv_act, "padding": padding},
    )
    if conv_act is None:
        (y,) = g.add_op("activation", [y], [(shape[0], oh, ow, gene.out_c)],
                        {"act": gene.act})
    return y


def _build_dwsep(g: OpGraph, x: int, gene: BlockGene, stride: int,
                 cfg: NASSpaceConfig) -> int:
    shape = g.tensor(x).shape
    in_c = shape[-1]
    k = gene.kernel
    oh, ow = _cdiv(shape[1], stride), _cdiv(shape[2], stride)
    (y,) = g.add_op(
        "dwconv2d", [x], [(shape[0], oh, ow, in_c)],
        {"kernel_h": k, "kernel_w": k, "stride": stride, "act": "relu"},
    )
    (y,) = g.add_op(
        "conv2d", [y], [(shape[0], oh, ow, gene.out_c)],
        {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1, "act": "relu"},
    )
    return y


def _se_module(g: OpGraph, x: int) -> int:
    """Squeeze-and-Excite: mean → FC(C/4) → relu → FC(C) → sigmoid → mul."""
    shape = g.tensor(x).shape
    c = shape[-1]
    mid = max(4, c // 4)
    (s,) = g.add_op("mean", [x], [(shape[0], c)], {"kernel_h": shape[1], "kernel_w": shape[2]})
    (s,) = g.add_op("fully_connected", [s], [(shape[0], mid)], {"act": "relu"})
    (s,) = g.add_op("fully_connected", [s], [(shape[0], c)], {})
    # LOGISTIC is a separate TFLite node — fusable by Alg. C.1.
    (s,) = g.add_op("activation", [s], [(shape[0], c)], {"act": "sigmoid"})
    # Broadcast-mul back over the spatial map.
    (s,) = g.add_op("elementwise", [x, s], [shape], {"ew_kind": "mul"})
    return s


def _build_bottleneck(g: OpGraph, x: int, gene: BlockGene, stride: int,
                      cfg: NASSpaceConfig) -> int:
    shape = g.tensor(x).shape
    in_c = shape[-1]
    k = gene.kernel
    mid_c = in_c * gene.expansion
    h = x
    if gene.expansion != 1:
        (h,) = g.add_op(
            "conv2d", [h], [(shape[0], shape[1], shape[2], mid_c)],
            {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1, "act": "relu6"},
        )
    oh, ow = _cdiv(shape[1], stride), _cdiv(shape[2], stride)
    (h,) = g.add_op(
        "dwconv2d", [h], [(shape[0], oh, ow, mid_c)],
        {"kernel_h": k, "kernel_w": k, "stride": stride, "act": "relu6"},
    )
    if gene.use_se:
        h = _se_module(g, h)
    (h,) = g.add_op(
        "conv2d", [h], [(shape[0], oh, ow, gene.out_c)],
        {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1},
    )
    if stride == 1 and gene.out_c == in_c:
        (h,) = g.add_op("elementwise", [h, x], [(shape[0], oh, ow, gene.out_c)],
                        {"ew_kind": "add"})
    return h


def _build_pool(g: OpGraph, x: int, gene: BlockGene, stride: int,
                cfg: NASSpaceConfig) -> int:
    shape = g.tensor(x).shape
    in_c = shape[-1]
    kind = gene.pool_kind if gene.pool_kind in ("pool_avg", "pool_max") else "pool_avg"
    k = gene.kernel if gene.kernel in (1, 3) else 3
    oh, ow = _cdiv(shape[1], stride), _cdiv(shape[2], stride)
    (y,) = g.add_op(
        kind, [x], [(shape[0], oh, ow, in_c)],
        {"kernel_h": k, "kernel_w": k, "stride": stride},
    )
    if gene.out_c != in_c:  # 1×1 projection to realize the sampled Cᵢ
        (y,) = g.add_op(
            "conv2d", [y], [(shape[0], oh, ow, gene.out_c)],
            {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1},
        )
    return y


def _build_split(g: OpGraph, x: int, gene: BlockGene, stride: int,
                 cfg: NASSpaceConfig) -> int:
    shape = g.tensor(x).shape
    in_c = shape[-1]
    if stride == 2:  # halve spatially first (split has no stride)
        (x,) = g.add_op(
            "pool_max", [x], [(shape[0], _cdiv(shape[1], 2), _cdiv(shape[2], 2), in_c)],
            {"kernel_h": 3, "kernel_w": 3, "stride": 2},
        )
        shape = g.tensor(x).shape
    n = gene.n_splits
    if n < 2 or n > 4 or in_c % n != 0:
        return _build_conv(g, x, gene, 1, cfg)   # conv fallback
    part_c = in_c // n
    parts = g.add_op(
        "split", [x], [(shape[0], shape[1], shape[2], part_c)] * n,
        {"num_splits": n, "axis": -1},
    )
    kinds = gene.ew_kinds or (EW_KINDS[0],)
    outs = []
    for j, pt in enumerate(parts):
        (o,) = g.add_op("elementwise", [pt],
                        [(shape[0], shape[1], shape[2], part_c)],
                        {"ew_kind": kinds[j % len(kinds)]})
        outs.append(o)
    (y,) = g.add_op("concat", outs, [(shape[0], shape[1], shape[2], in_c)],
                    {"axis": -1})
    if gene.out_c != in_c:
        (y,) = g.add_op(
            "conv2d", [y], [(shape[0], shape[1], shape[2], gene.out_c)],
            {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1},
        )
    return y


_BUILDERS = {
    "conv": _build_conv,
    "dwsep": _build_dwsep,
    "bottleneck": _build_bottleneck,
    "pool": _build_pool,
    "split": _build_split,
}


def _emit_head(g: OpGraph, x: int, head_c: int, cfg: NASSpaceConfig) -> None:
    """Head: 1×1 conv to C10, global mean, FC to `classes`."""
    shape = g.tensor(x).shape
    (x,) = g.add_op(
        "conv2d", [x], [(shape[0], shape[1], shape[2], head_c)],
        {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1, "act": "relu"},
    )
    (x,) = g.add_op("mean", [x], [(shape[0], head_c)],
                    {"kernel_h": shape[1], "kernel_w": shape[2]})
    (x,) = g.add_op("fully_connected", [x], [(shape[0], cfg.classes)], {})
    g.mark_output(x)


def decode_genotype(gt, cfg: Optional[NASSpaceConfig] = None,
                    name: Optional[str] = None) -> OpGraph:
    """Build the genotype's `OpGraph` (deterministic; mildly invalid genes
    — stale group counts, impossible splits — repair to their documented
    fallbacks rather than raising, so search operators stay total).

    Dispatches on genotype family: block/elastic `Genotype` chains and
    arbitrary-topology `RandomWiredGenotype` DAGs decode through the same
    entry point, so every downstream layer (fusion, featurization,
    serving, search) is family-agnostic.
    """
    if isinstance(gt, RandomWiredGenotype):
        return decode_random_wired(gt, cfg, name)
    cfg = cfg or NASSpaceConfig()
    g = OpGraph(name or f"nas_g{gt.digest()}")
    x = g.add_input((1, cfg.resolution, cfg.resolution, 3))
    for i, gene in enumerate(gt.blocks):
        stride = 2 if (i + 1) in cfg.halve_after else 1
        builder = _BUILDERS.get(gene.kind)
        if builder is None:
            raise ValueError(f"unknown block kind {gene.kind!r}")
        # Elastic depth: repeat the block, stride spent on the first
        # repeat only (OFA-style stacked units sharing one gene).
        for r in range(max(1, int(gene.depth))):
            x = builder(g, x, gene, stride if r == 0 else 1, cfg)
    _emit_head(g, x, gt.head_c, cfg)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Sample-only convenience (sampling + decode)
# ---------------------------------------------------------------------------

def sample_architecture(seed: int, cfg: Optional[NASSpaceConfig] = None) -> OpGraph:
    """Sample one synthetic NA (deterministic in `seed`)."""
    cfg = cfg or NASSpaceConfig()
    return decode_genotype(sample_genotype(seed, cfg), cfg, name=f"nas_{seed}")


def sample_dataset(n: int, cfg: Optional[NASSpaceConfig] = None,
                   seed0: int = 0) -> List[OpGraph]:
    return [sample_architecture(seed0 + i, cfg) for i in range(n)]


# ---------------------------------------------------------------------------
# Elastic family (OFA-style): bottleneck chains whose kernel / depth /
# width / expand knobs move one rung at a time under shrink/grow
# operators (repro.search.encoding) and score against the weight-sharing
# supernet objective (repro.search.objectives.SupernetQuality).
# ---------------------------------------------------------------------------

ELASTIC_DEPTHS = (1, 2, 3)


def elastic_genotype_from_rng(rng: np.random.Generator,
                              cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """Draw one elastic genotype: every block a bottleneck with independent
    kernel/depth/expand/width knobs (the OFA search unit)."""
    cfg = cfg or NASSpaceConfig()
    genes: List[BlockGene] = []
    for i in range(cfg.num_blocks):
        stage = 0 if i < 5 else 1
        out_c = _rint(rng, *STAGE_CHANNEL_RANGES[stage], cfg.channel_scale)
        genes.append(BlockGene(
            "bottleneck", out_c,
            kernel=int(rng.choice([3, 5, 7])),
            expansion=int(rng.choice([1, 3, 6])),
            use_se=bool(rng.random() < 0.5),
            depth=int(rng.choice(ELASTIC_DEPTHS)),
        ))
    head_c = _rint(rng, *HEAD_CHANNEL_RANGE, cfg.channel_scale)
    return Genotype(tuple(genes), head_c, family="elastic")


def sample_elastic_genotype(seed: int,
                            cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    return elastic_genotype_from_rng(np.random.default_rng(seed), cfg)


# ---------------------------------------------------------------------------
# Random-wired family ("Exploring Randomly Wired Neural Networks"):
# per-stage random DAGs sampled from classic graph models — WS
# (Watts-Strogatz small world), ER (Erdős-Rényi), BA (Barabási-Albert
# preferential attachment) — DAG-ified by orienting edges low→high
# node index.  Arbitrary fan-out/fan-in stresses the fusion pass and
# per-op featurization far harder than chain blocks; optional
# encoder-decoder skeletons (resize-up + skip concat, U-Net style)
# cover dense-prediction workloads.
# ---------------------------------------------------------------------------

RW_MODELS = ("ws", "er", "ba")
RW_NODE_KINDS = ("sep", "conv", "pool_avg", "pool_max")
_RW_KIND_P = (0.4, 0.3, 0.15, 0.15)


@dataclass
class RandomWiredConfig:
    """Generator knobs for `random_wired_genotype`."""

    model: str = "ws"            # "ws" | "er" | "ba" | "mixed"
    stages: int = 3
    nodes_per_stage: int = 8
    ws_k: int = 4                # WS: ring-lattice degree
    ws_p: float = 0.25           # WS: rewire probability
    er_p: float = 0.3            # ER: edge probability
    ba_m: int = 2                # BA: edges per arriving node
    stem_c: int = 16
    channel_mult: float = 2.0    # per-stage width growth
    channel_scale: float = 1.0   # scales stem/stage/head widths
    encdec_prob: float = 0.0     # fraction of samples with a decoder half

    def to_json(self) -> Dict[str, Any]:
        return {
            "model": self.model, "stages": self.stages,
            "nodes_per_stage": self.nodes_per_stage, "ws_k": self.ws_k,
            "ws_p": self.ws_p, "er_p": self.er_p, "ba_m": self.ba_m,
            "stem_c": self.stem_c, "channel_mult": self.channel_mult,
            "channel_scale": self.channel_scale,
            "encdec_prob": self.encdec_prob,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RandomWiredConfig":
        return cls(**d)


@dataclass(frozen=True)
class StageGene:
    """One random DAG stage: nodes, oriented edges (a < b), per-node op."""

    num_nodes: int
    edges: Tuple[Tuple[int, int], ...]
    kinds: Tuple[str, ...]
    kernels: Tuple[int, ...]
    out_c: int

    def to_json(self) -> Dict[str, Any]:
        return {"num_nodes": self.num_nodes,
                "edges": [list(e) for e in self.edges],
                "kinds": list(self.kinds), "kernels": list(self.kernels),
                "out_c": self.out_c}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "StageGene":
        return cls(int(d["num_nodes"]),
                   tuple((int(a), int(b)) for a, b in d["edges"]),
                   tuple(d["kinds"]), tuple(int(k) for k in d["kernels"]),
                   int(d["out_c"]))


@dataclass(frozen=True)
class RandomWiredGenotype:
    """One random-wired architecture: stage DAGs + stem/head widths."""

    stages: Tuple[StageGene, ...]
    stem_c: int
    head_c: int
    model: str = "ws"
    encdec: bool = False
    family: str = "random_wired"

    def to_json(self) -> Dict[str, Any]:
        return {"family": "random_wired",
                "stages": [s.to_json() for s in self.stages],
                "stem_c": self.stem_c, "head_c": self.head_c,
                "model": self.model, "encdec": self.encdec}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RandomWiredGenotype":
        return cls(tuple(StageGene.from_json(s) for s in d["stages"]),
                   int(d["stem_c"]), int(d["head_c"]),
                   model=str(d.get("model", "ws")),
                   encdec=bool(d.get("encdec", False)))

    def digest(self) -> str:
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def canonical_edges(edges, num_nodes: int) -> Tuple[Tuple[int, int], ...]:
    """Orient low→high, clamp to range, dedupe, sort — the one canonical
    representation (mutation products repair through this too)."""
    out = set()
    for a, b in edges:
        a, b = int(a), int(b)
        if a == b:
            continue
        a, b = (a, b) if a < b else (b, a)
        if 0 <= a and b < num_nodes:
            out.add((a, b))
    return tuple(sorted(out))


def _ws_edges(rng: np.random.Generator, n: int, k: int, p: float) -> List[Tuple[int, int]]:
    edges = []
    for i in range(n):
        for j in range(1, max(1, k // 2) + 1):
            b = (i + j) % n
            if rng.random() < p:
                b = int(rng.integers(0, n))
            edges.append((i, b))
    return edges


def _er_edges(rng: np.random.Generator, n: int, p: float) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def _ba_edges(rng: np.random.Generator, n: int, m: int) -> List[Tuple[int, int]]:
    m = max(1, min(m, n - 1))
    edges = []
    degree = [0] * n
    for j in range(m, n):   # nodes 0..m-1 seed the graph
        # Preferential attachment: weight by degree + 1 (so seeds are
        # reachable before any edges exist).
        w = np.array([degree[i] + 1.0 for i in range(j)])
        w = w / w.sum()
        targets = rng.choice(j, size=min(m, j), replace=False, p=w)
        for t in targets:
            edges.append((int(t), j))
            degree[int(t)] += 1
            degree[j] += 1
    return edges


def random_wired_genotype(rng: np.random.Generator,
                          cfg: Optional[RandomWiredConfig] = None
                          ) -> RandomWiredGenotype:
    """Draw one random-wired genotype (seed-for-seed deterministic)."""
    cfg = cfg or RandomWiredConfig()
    model = cfg.model
    if model == "mixed":
        model = str(rng.choice(RW_MODELS))
    if model not in RW_MODELS:
        raise ValueError(f"unknown random-wired model {model!r}")
    stem_c = max(4, int(round(cfg.stem_c * cfg.channel_scale)))
    stages: List[StageGene] = []
    for s in range(cfg.stages):
        n = cfg.nodes_per_stage
        if model == "ws":
            raw = _ws_edges(rng, n, cfg.ws_k, cfg.ws_p)
        elif model == "er":
            raw = _er_edges(rng, n, cfg.er_p)
        else:
            raw = _ba_edges(rng, n, cfg.ba_m)
        kinds = tuple(str(rng.choice(RW_NODE_KINDS, p=_RW_KIND_P))
                      for _ in range(n))
        kernels = tuple(int(rng.choice([3, 5])) for _ in range(n))
        out_c = max(8, int(round(stem_c * cfg.channel_mult ** (s + 1))))
        stages.append(StageGene(n, canonical_edges(raw, n), kinds, kernels,
                                out_c))
    head_c = _rint(rng, *HEAD_CHANNEL_RANGE, cfg.channel_scale)
    encdec = bool(rng.random() < cfg.encdec_prob)
    return RandomWiredGenotype(tuple(stages), stem_c, head_c, model=model,
                               encdec=encdec)


def sample_random_wired(seed: int,
                        cfg: Optional[RandomWiredConfig] = None
                        ) -> RandomWiredGenotype:
    return random_wired_genotype(np.random.default_rng(seed), cfg)


def _rw_aggregate(g: OpGraph, tids: List[int]) -> int:
    """Join fan-in > 1 by a chain of binary adds (the paper-space
    aggregation node of Xie et al., expressed in linkable ops)."""
    y = tids[0]
    shape = g.tensor(y).shape
    for t in tids[1:]:
        (y,) = g.add_op("elementwise", [y, t], [shape], {"ew_kind": "add"})
    return y


def _rw_node(g: OpGraph, x: int, kind: str, kernel: int, out_c: int,
             stride: int) -> int:
    """One random-wired node: ReLU-op-project unit on its aggregate input."""
    shape = g.tensor(x).shape
    in_c = shape[-1]
    oh, ow = _cdiv(shape[1], stride), _cdiv(shape[2], stride)
    if kind == "sep":   # depthwise-separable (Xie et al.'s default unit)
        (y,) = g.add_op(
            "dwconv2d", [x], [(shape[0], oh, ow, in_c)],
            {"kernel_h": kernel, "kernel_w": kernel, "stride": stride,
             "act": "relu"})
        (y,) = g.add_op(
            "conv2d", [y], [(shape[0], oh, ow, out_c)],
            {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1,
             "act": "relu"})
        return y
    if kind == "conv":
        (y,) = g.add_op(
            "conv2d", [x], [(shape[0], oh, ow, out_c)],
            {"kernel_h": kernel, "kernel_w": kernel, "stride": stride,
             "groups": 1, "act": "relu"})
        return y
    pool = kind if kind in ("pool_avg", "pool_max") else "pool_avg"
    (y,) = g.add_op(
        pool, [x], [(shape[0], oh, ow, in_c)],
        {"kernel_h": 3, "kernel_w": 3, "stride": stride})
    if out_c != in_c:
        (y,) = g.add_op(
            "conv2d", [y], [(shape[0], oh, ow, out_c)],
            {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1})
    return y


def _decode_stage(g: OpGraph, x: int, sg: StageGene, stride: int) -> int:
    """Decode one stage DAG.  In-degree-0 nodes consume the stage input
    (and spend the stage stride); fan-in > 1 aggregates by add chains;
    out-degree-0 nodes join into the stage output."""
    n = sg.num_nodes
    in_edges: Dict[int, List[int]] = {j: [] for j in range(n)}
    out_deg = [0] * n
    for a, b in sg.edges:
        in_edges[b].append(a)
        out_deg[a] += 1
    outs: Dict[int, int] = {}
    for j in range(n):
        srcs = sorted(in_edges[j])
        if not srcs:
            xin, s = x, stride
        else:
            xin, s = _rw_aggregate(g, [outs[a] for a in srcs]), 1
        outs[j] = _rw_node(g, xin, sg.kinds[j], sg.kernels[j], sg.out_c, s)
    tails = [outs[j] for j in range(n) if out_deg[j] == 0]
    return _rw_aggregate(g, tails)


def decode_random_wired(gt: RandomWiredGenotype,
                        cfg: Optional[NASSpaceConfig] = None,
                        name: Optional[str] = None) -> OpGraph:
    """Build a random-wired genotype's `OpGraph`.

    ``encdec`` genotypes add a decoder half: each level resizes ×2 back
    to the matching encoder stage's resolution, concats the skip, and
    projects 1×1 — a U-Net skeleton whose skip edges give encoder stage
    outputs fan-out ≥ 2 on top of the DAG's own arbitrary fan-out.
    """
    cfg = cfg or NASSpaceConfig()
    g = OpGraph(name or f"rw_{gt.digest()}")
    x = g.add_input((1, cfg.resolution, cfg.resolution, 3))
    shape = g.tensor(x).shape
    (x,) = g.add_op(
        "conv2d", [x], [(shape[0], shape[1], shape[2], gt.stem_c)],
        {"kernel_h": 3, "kernel_w": 3, "stride": 1, "groups": 1,
         "act": "relu"})
    skips: List[int] = []
    for sg in gt.stages:
        x = _decode_stage(g, x, sg, stride=2)
        skips.append(x)
    if gt.encdec and len(gt.stages) > 1:
        for level in range(len(gt.stages) - 2, -1, -1):
            skip = skips[level]
            sshape = g.tensor(skip).shape
            cshape = g.tensor(x).shape
            (x,) = g.add_op(
                "resize", [x],
                [(cshape[0], sshape[1], sshape[2], cshape[3])],
                {"mode": "nearest"})
            (x,) = g.add_op(
                "concat", [x, skip],
                [(sshape[0], sshape[1], sshape[2], cshape[3] + sshape[3])],
                {"axis": -1})
            (x,) = g.add_op(
                "conv2d", [x], [sshape],
                {"kernel_h": 1, "kernel_w": 1, "stride": 1, "groups": 1,
                 "act": "relu"})
    _emit_head(g, x, gt.head_c, cfg)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Family-agnostic (de)serialization — checkpoints, reports, goldens
# ---------------------------------------------------------------------------

def genotype_from_json(d: Dict[str, Any]):
    """Load any genotype family from its `to_json` form."""
    if d.get("family") == "random_wired":
        return RandomWiredGenotype.from_json(d)
    return Genotype.from_json(d)
