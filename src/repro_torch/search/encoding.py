"""Genotype operators: the search space's mutation/crossover algebra.

The genotype itself (`BlockGene`/`Genotype`) and its decode live with
the space definition in `repro_torch.core.nas_space`; this module adds
what a search loop needs on top:

  * `random_genotype` — one uniform draw from the paper's distribution;
  * `mutate` — one seeded random edit (block kind, kernel, channels, or
    a kind-specific parameter), the unit step of regularized evolution;
  * `crossover` — uniform block-wise recombination of two parents;
  * `repair` — deterministic canonicalization: genes whose context a
    mutation invalidated (group counts that no longer divide the
    channels, splits with no divisor) snap to their decoded fallbacks,
    and fields a kind does not read reset to defaults, so one decoded
    graph has exactly one genotype digest.

All operators are pure: they take an `np.random.Generator` and return
new `Genotype`s, so a search driver that checkpoints its rng state
replays them bit-for-bit.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.ir import OpGraph
from repro_torch.core.nas_space import (ACTS, BLOCK_KINDS, ELASTIC_DEPTHS,
                                        EW_KINDS, HEAD_CHANNEL_RANGE,
                                        RW_NODE_KINDS, STAGE_CHANNEL_RANGES,
                                        BlockGene, Genotype, NASSpaceConfig,
                                        RandomWiredConfig,
                                        RandomWiredGenotype, StageGene,
                                        canonical_edges, decode_genotype,
                                        elastic_genotype_from_rng,
                                        genotype_from_rng,
                                        random_wired_genotype, _rint,
                                        _sample_gene)

KERNELS = (3, 5, 7)
POOL_KERNELS = (1, 3)
EXPANSIONS = (1, 3, 6)
SPLITS = (2, 3, 4)
RW_KERNELS = (3, 5)
ELASTIC_KNOBS = ("kernel", "depth", "expansion", "width")


def channel_range(block_index: int) -> Tuple[int, int]:
    """Paper Fig. 12 channel range for one block position (shared
    constants with the sampler, scaled by cfg through `_rint`)."""
    return STAGE_CHANNEL_RANGES[0] if block_index < 5 \
        else STAGE_CHANNEL_RANGES[1]


def random_genotype(rng: np.random.Generator,
                    cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """One uniform draw (same distribution as `sample_architecture`)."""
    return repair(genotype_from_rng(rng, cfg), cfg)


def random_elastic_genotype(rng: np.random.Generator,
                            cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """One elastic draw (canonical; family == "elastic")."""
    return repair(elastic_genotype_from_rng(rng, cfg), cfg)


def random_wired(rng: np.random.Generator,
                 cfg: Optional[RandomWiredConfig] = None
                 ) -> RandomWiredGenotype:
    """One random-wired draw (generator output is already canonical)."""
    return random_wired_genotype(rng, cfg)


def decode(gt, cfg: Optional[NASSpaceConfig] = None,
           name: Optional[str] = None) -> OpGraph:
    """Genotype → `OpGraph` (named by digest so equal genotypes dedup
    through every fingerprint-keyed cache)."""
    return decode_genotype(gt, cfg, name=name)


# ---------------------------------------------------------------------------
# Canonicalization
# ---------------------------------------------------------------------------

def _canonical_gene(gene: BlockGene, in_c: int, stride: int) -> BlockGene:
    """Snap one gene to canonical form given its channel/stride context."""
    out_c = max(4, int(gene.out_c))
    # Elastic depth applies to conv/dwsep/bottleneck repeats; kinds that
    # don't read it reset to 1 so equal graphs keep one digest.
    depth = min(max(int(gene.depth), 1), ELASTIC_DEPTHS[-1]) \
        if gene.kind in ("conv", "dwsep", "bottleneck") else 1
    base = BlockGene(gene.kind, out_c, depth=depth)
    if gene.kind == "conv":
        groups = gene.groups
        if not (groups > 1 and in_c % groups == 0 and out_c % groups == 0):
            groups = 1
        kernel = gene.kernel if gene.kernel in KERNELS else KERNELS[0]
        act = gene.act if gene.act in ACTS else ACTS[0]
        # explicit_pad only decodes at stride 2 — clear it elsewhere so
        # graph-level no-op flips don't mint fresh digests.
        return replace(base, kernel=kernel, groups=groups, act=act,
                       explicit_pad=gene.explicit_pad and stride == 2)
    if gene.kind == "dwsep":
        kernel = gene.kernel if gene.kernel in KERNELS else KERNELS[0]
        return replace(base, kernel=kernel)
    if gene.kind == "bottleneck":
        kernel = gene.kernel if gene.kernel in KERNELS else KERNELS[0]
        expansion = gene.expansion if gene.expansion in EXPANSIONS else EXPANSIONS[0]
        return replace(base, kernel=kernel, expansion=expansion,
                       use_se=gene.use_se)
    if gene.kind == "pool":
        kernel = gene.kernel if gene.kernel in POOL_KERNELS else POOL_KERNELS[1]
        pool_kind = gene.pool_kind if gene.pool_kind in ("pool_avg", "pool_max") \
            else "pool_avg"
        return replace(base, kernel=kernel, pool_kind=pool_kind)
    if gene.kind == "split":
        n = gene.n_splits
        if n in SPLITS and in_c % n == 0:
            kinds = tuple(k if k in EW_KINDS else EW_KINDS[0]
                          for k in gene.ew_kinds[:n])
            kinds = kinds + (EW_KINDS[0],) * (n - len(kinds))
            return replace(base, n_splits=n, ew_kinds=kinds)
        # Conv fallback: keep the conv-relevant fields, canonicalized
        # (the fallback conv runs at stride 1, so no explicit pad).
        fb = _canonical_gene(replace(gene, kind="conv", n_splits=0,
                                     ew_kinds=()), in_c, stride=1)
        return replace(fb, kind="split", depth=1)
    raise ValueError(f"unknown block kind {gene.kind!r}")


def repair(gt, cfg: Optional[NASSpaceConfig] = None):
    """Canonical form of ``gt``: every gene valid in its channel context,
    inapplicable fields at defaults.  Idempotent; decode(repair(g)) ==
    decode(g) for genes the decoder would have repaired on the fly.
    Dispatches on genotype family (random-wired repairs its stage DAGs)."""
    if isinstance(gt, RandomWiredGenotype):
        return repair_random_wired(gt)
    cfg = cfg or NASSpaceConfig()
    blocks = []
    in_c = 3
    for i, gene in enumerate(gt.blocks):
        stride = 2 if (i + 1) in cfg.halve_after else 1
        fixed = _canonical_gene(gene, in_c, stride)
        blocks.append(fixed)
        in_c = fixed.out_c
    return Genotype(tuple(blocks), max(4, int(gt.head_c)), family=gt.family)


def repair_random_wired(gt: RandomWiredGenotype) -> RandomWiredGenotype:
    """Canonical form of a random-wired genotype: edges oriented low→high,
    deduped, in range; node kinds/kernels snapped to their ladders."""
    stages = tuple(
        replace(
            s,
            edges=canonical_edges(s.edges, s.num_nodes),
            kinds=tuple(k if k in RW_NODE_KINDS else RW_NODE_KINDS[0]
                        for k in s.kinds),
            kernels=tuple(k if k in RW_KERNELS else RW_KERNELS[0]
                          for k in s.kernels),
            out_c=max(8, int(s.out_c)),
        )
        for s in gt.stages)
    return replace(gt, stages=stages, stem_c=max(4, int(gt.stem_c)),
                   head_c=max(4, int(gt.head_c)))


# ---------------------------------------------------------------------------
# Mutation
# ---------------------------------------------------------------------------

def _choice_not(rng: np.random.Generator, options, current):
    """Uniform choice among ``options`` minus ``current`` (if possible)."""
    pool = [o for o in options if o != current] or list(options)
    return pool[int(rng.integers(0, len(pool)))]


def _mutate_param(gene: BlockGene, in_c: int, stride: int,
                  rng: np.random.Generator) -> BlockGene:
    """Re-roll one kind-specific parameter of ``gene``."""
    if gene.kind == "conv":
        # explicit_pad only decodes at stride 2 — don't offer a no-op
        # toggle elsewhere.
        which = int(rng.integers(0, 3 if stride == 2 else 2))
        if which == 0:     # grouping
            cand = [4 * i for i in range(1, 17)
                    if in_c % (4 * i) == 0 and gene.out_c % (4 * i) == 0]
            groups = int(rng.choice(cand)) if cand and rng.random() < 0.5 else 1
            return replace(gene, groups=groups)
        if which == 1:
            return replace(gene, act=_choice_not(rng, ACTS, gene.act))
        return replace(gene, explicit_pad=not gene.explicit_pad)
    if gene.kind == "dwsep":
        return replace(gene, kernel=_choice_not(rng, KERNELS, gene.kernel))
    if gene.kind == "bottleneck":
        if rng.random() < 0.5:
            return replace(gene, expansion=_choice_not(rng, EXPANSIONS,
                                                       gene.expansion))
        return replace(gene, use_se=not gene.use_se)
    if gene.kind == "pool":
        if rng.random() < 0.5:
            return replace(gene, kernel=_choice_not(rng, POOL_KERNELS,
                                                    gene.kernel))
        return replace(gene, pool_kind="pool_max" if gene.pool_kind == "pool_avg"
                       else "pool_avg")
    # split: re-roll the branch count (repair handles divisibility) and
    # branch op kinds together.
    n = int(rng.choice(SPLITS))
    kinds = tuple(str(rng.choice(EW_KINDS)) for _ in range(n))
    return replace(gene, n_splits=n, ew_kinds=kinds)


# ---------------------------------------------------------------------------
# Elastic shrink/grow: the OFA knob-step operators.  One seeded choice of
# (block, knob), one rung down/up its ladder, everything else shared —
# the minimal edit a weight-sharing supernet can absorb.
# ---------------------------------------------------------------------------

def width_ladder(block_index: int,
                 cfg: Optional[NASSpaceConfig] = None) -> Tuple[int, ...]:
    """Quantized width rungs for one block position (4 evenly spaced
    values over the stage's Fig. 12 range, scaled like `_rint`)."""
    cfg = cfg or NASSpaceConfig()
    lo, hi = channel_range(block_index)
    raw = np.linspace(lo, hi, 4)
    rungs = sorted({max(4, int(round(v * cfg.channel_scale))) for v in raw})
    return tuple(rungs)


def _ladder_step(value, ladder, direction: int):
    """Snap ``value`` to its nearest rung, then step ``direction`` rungs
    (clamped at the ends)."""
    idx = min(range(len(ladder)), key=lambda i: (abs(ladder[i] - value), i))
    return ladder[min(len(ladder) - 1, max(0, idx + direction))]


def _elastic_step(gt: Genotype, rng: np.random.Generator, direction: int,
                  cfg: Optional[NASSpaceConfig]) -> Genotype:
    cfg = cfg or NASSpaceConfig()
    site = int(rng.integers(0, len(gt.blocks)))
    knob = ELASTIC_KNOBS[int(rng.integers(0, len(ELASTIC_KNOBS)))]
    gene = gt.blocks[site]
    if knob == "kernel":
        new = replace(gene, kernel=_ladder_step(gene.kernel, KERNELS,
                                                direction))
    elif knob == "depth":
        new = replace(gene, depth=_ladder_step(gene.depth, ELASTIC_DEPTHS,
                                               direction))
    elif knob == "expansion":
        new = replace(gene, expansion=_ladder_step(gene.expansion, EXPANSIONS,
                                                   direction))
    else:
        new = replace(gene, out_c=_ladder_step(gene.out_c,
                                               width_ladder(site, cfg),
                                               direction))
    return repair(gt.replace_block(site, new), cfg)


def shrink(gt: Genotype, rng: np.random.Generator,
           cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """Step one seeded-chosen knob one rung DOWN (subnet of the parent)."""
    return _elastic_step(gt, rng, -1, cfg)


def grow(gt: Genotype, rng: np.random.Generator,
         cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """Step one seeded-chosen knob one rung UP (supernet-ward)."""
    return _elastic_step(gt, rng, +1, cfg)


def mutate_elastic(gt: Genotype, rng: np.random.Generator,
                   cfg: Optional[NASSpaceConfig] = None) -> Genotype:
    """Elastic unit step: a seeded coin picks shrink or grow."""
    direction = 1 if rng.random() < 0.5 else -1
    return _elastic_step(gt, rng, direction, cfg)


# ---------------------------------------------------------------------------
# Random-wired operators
# ---------------------------------------------------------------------------

def mutate_random_wired(gt: RandomWiredGenotype, rng: np.random.Generator,
                        cfg=None) -> RandomWiredGenotype:
    """One random edit of a stage DAG (edge add/drop/rewire, node kind or
    kernel flip, stage width) or the head width.  Canonical result."""
    n_stages = len(gt.stages)
    site = int(rng.integers(0, n_stages + 1))
    if site == n_stages:
        head = max(4, int(round(gt.head_c * float(rng.uniform(0.75, 1.25)))))
        return repair_random_wired(replace(gt, head_c=head))
    sg = gt.stages[site]
    n = sg.num_nodes
    move = int(rng.integers(0, 6))
    edges = list(sg.edges)
    kinds, kernels, out_c = sg.kinds, sg.kernels, sg.out_c
    if move == 0 and n > 1:        # add an edge (dedupe via canonical form)
        a = int(rng.integers(0, n - 1))
        b = int(rng.integers(a + 1, n))
        edges.append((a, b))
    elif move == 1 and edges:      # drop an edge
        del edges[int(rng.integers(0, len(edges)))]
    elif move == 2 and edges and n > 1:   # rewire one endpoint
        i = int(rng.integers(0, len(edges)))
        a, b = edges[i]
        if rng.random() < 0.5:
            a = int(rng.integers(0, n))
        else:
            b = int(rng.integers(0, n))
        edges[i] = (a, b)
    elif move == 3:                # node op kind
        j = int(rng.integers(0, n))
        kinds = tuple(_choice_not(rng, RW_NODE_KINDS, kinds[j])
                      if i == j else k for i, k in enumerate(kinds))
    elif move == 4:                # node kernel
        j = int(rng.integers(0, n))
        kernels = tuple(_choice_not(rng, RW_KERNELS, kernels[j])
                        if i == j else k for i, k in enumerate(kernels))
    else:                          # stage width
        out_c = max(8, int(round(sg.out_c * float(rng.uniform(0.75, 1.25)))))
    stages = tuple(replace(sg, edges=tuple(edges), kinds=kinds,
                           kernels=kernels, out_c=out_c)
                   if i == site else s for i, s in enumerate(gt.stages))
    return repair_random_wired(replace(gt, stages=stages))


def crossover_random_wired(a: RandomWiredGenotype, b: RandomWiredGenotype,
                           rng: np.random.Generator,
                           cfg=None) -> RandomWiredGenotype:
    """Uniform stage-wise recombination (stages are self-contained DAGs,
    so they swap cleanly); topology skeleton — stage count, model,
    encdec — follows parent ``a``."""
    stages = tuple(
        a.stages[i] if (i >= len(b.stages) or rng.random() < 0.5)
        else b.stages[i]
        for i in range(len(a.stages)))
    head = a.head_c if rng.random() < 0.5 else b.head_c
    return repair_random_wired(replace(a, stages=stages, head_c=head))


def mutate(gt, rng: np.random.Generator,
           cfg: Optional[NASSpaceConfig] = None):
    """One random edit: the unit step of regularized evolution.

    Dispatches on genotype family — random-wired DAG edits, elastic
    shrink/grow knob steps, or (block family) the edit menu below.
    Edit sites are the blocks plus the head; block edits choose among
    kind change (parameters resampled for the new kind), kernel change,
    output-channel change (stage-appropriate range), or a kind-specific
    parameter re-roll.  The result is canonical (`repair`).
    """
    if isinstance(gt, RandomWiredGenotype):
        return mutate_random_wired(gt, rng, cfg)
    if gt.family == "elastic":
        return mutate_elastic(gt, rng, cfg)
    cfg = cfg or NASSpaceConfig()
    nb = len(gt.blocks)
    site = int(rng.integers(0, nb + 1))
    if site == nb:
        head = _rint(rng, *HEAD_CHANNEL_RANGE, cfg.channel_scale)
        return repair(replace(gt, head_c=head), cfg)

    gene = gt.blocks[site]
    in_c = gt.blocks[site - 1].out_c if site > 0 else 3
    stride = 2 if (site + 1) in cfg.halve_after else 1
    move = int(rng.integers(0, 4))
    if move == 0:      # change block kind, resampling its parameters
        kind = _choice_not(rng, BLOCK_KINDS, gene.kind)
        new = _sample_gene(rng, kind, in_c, gene.out_c, stride, cfg)
    elif move == 1:    # kernel
        if gene.kind == "split" and gene.n_splits:
            # A realized split has no kernel (repair would reset it and
            # make the edit a silent no-op) — re-roll its branches.
            new = _mutate_param(gene, in_c, stride, rng)
        else:
            options = POOL_KERNELS if gene.kind == "pool" else KERNELS
            new = replace(gene, kernel=_choice_not(rng, options, gene.kernel))
    elif move == 2:    # output channels (stage-appropriate range)
        out_c = _rint(rng, *channel_range(site), cfg.channel_scale)
        new = replace(gene, out_c=out_c)
    else:              # kind-specific parameter
        new = _mutate_param(gene, in_c, stride, rng)
    return repair(gt.replace_block(site, new), cfg)


def crossover(a, b, rng: np.random.Generator,
              cfg: Optional[NASSpaceConfig] = None):
    """Uniform block-wise recombination (head from either parent).
    Dispatches on genotype family; parents must share one."""
    if isinstance(a, RandomWiredGenotype) or isinstance(b, RandomWiredGenotype):
        if not (isinstance(a, RandomWiredGenotype)
                and isinstance(b, RandomWiredGenotype)):
            raise ValueError("cannot cross genotypes of different families")
        return crossover_random_wired(a, b, rng, cfg)
    if len(a.blocks) != len(b.blocks):
        raise ValueError(
            f"cannot cross genotypes with {len(a.blocks)} vs "
            f"{len(b.blocks)} blocks")
    blocks = tuple(a.blocks[i] if rng.random() < 0.5 else b.blocks[i]
                   for i in range(len(a.blocks)))
    head = a.head_c if rng.random() < 0.5 else b.head_c
    return repair(Genotype(blocks, head, family=a.family), cfg)
