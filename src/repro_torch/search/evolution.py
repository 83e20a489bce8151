"""Predictor-in-the-loop evolutionary NAS (regularized/aging evolution).

The engine never measures a candidate: each generation's new genotypes
are decoded and scored with ONE `LatencyService.predict_batch` call per
device setting (the compiled fast path), quality comes from a pluggable
proxy, and only the final front is verified on a `ProfileSession` —
the paper's §1 motivation (measuring every candidate is impractical;
predictions make search scale) as a working loop.

Loop shape (Real et al.'s aging evolution + NSGA-II selection
machinery):

  gen 0   seed `population_size` uniform samples, score, found the front
  gen k   produce `children_per_gen` children by crowded-tournament
          parent selection (feasibility → Pareto rank → crowding),
          crossover+mutation, score the batch, update the front,
          append children and age out the oldest

Constraint handling: a candidate is *feasible* iff it meets its budget
on every `DeviceBudget` device; only feasible candidates enter the
front, and infeasible tournament entrants lose to feasible ones (among
infeasible, smaller relative violation wins).

Determinism: every stochastic choice flows through one
`np.random.Generator` whose state is checkpointed, scores are memoized
by genotype digest (a candidate is scored at most once per search, so
replays batch the same fresh rows), and front/stat orderings are
canonical — a seeded run, a re-run, and a checkpoint/resume all produce
bit-identical fronts.  Checkpoints are plain JSON (`save`/`load`).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.nas_space import (Genotype, NASSpaceConfig,
                                        RandomWiredConfig, genotype_from_json)
from repro_torch.core.profiler import DeviceSetting, ProfileSession
from repro_torch.search import encoding
from repro_torch.search.objectives import DeviceBudget, LatencyScorer, make_quality
from repro_torch.search.pareto import (ParetoFront, crowding_distance,
                                       nondominated_rank)
from repro_torch.utils.logging import get_logger

log = get_logger("repro.search.evolution")

CHECKPOINT_VERSION = 1


@dataclass
class SearchConfig:
    """Everything a search run needs besides the service + budgets."""

    population_size: int = 64
    generations: int = 20          # total steps, incl. the seeding step
    children_per_gen: int = 32
    tournament_size: int = 8
    crossover_prob: float = 0.5
    seed: int = 0
    quality: str = "flops"         # repro.search.objectives.QUALITIES key
    front_capacity: Optional[int] = None
    resolution: int = 32
    channel_scale: float = 1.0
    family: str = "block"          # "block" | "elastic" | "random_wired"
    rw: Optional[Dict[str, Any]] = None   # RandomWiredConfig.to_json overrides

    def space(self) -> NASSpaceConfig:
        return NASSpaceConfig(resolution=self.resolution,
                              channel_scale=self.channel_scale)

    def rw_space(self) -> RandomWiredConfig:
        return RandomWiredConfig(**(self.rw or {}))

    def to_json(self) -> Dict[str, Any]:
        d = {
            "population_size": self.population_size,
            "generations": self.generations,
            "children_per_gen": self.children_per_gen,
            "tournament_size": self.tournament_size,
            "crossover_prob": self.crossover_prob,
            "seed": self.seed,
            "quality": self.quality,
            "front_capacity": self.front_capacity,
            "resolution": self.resolution,
            "channel_scale": self.channel_scale,
        }
        # Emitted only when non-default so pre-family checkpoint/report
        # JSON (and goldens pinned on it) stays byte-stable.
        if self.family != "block":
            d["family"] = self.family
        if self.rw is not None:
            d["rw"] = dict(self.rw)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SearchConfig":
        return cls(**d)


@dataclass
class GenStats:
    """Deterministic per-generation counters (no wall-clock inside —
    timing lives on the report so stats compare bit-exactly)."""

    gen: int
    produced: int                  # candidates emitted this generation
    new_scored: int                # digests not seen before (memo misses)
    predict_calls: int             # predict_batch calls (== devices, or 0)
    feasible_new: int              # of new_scored, how many met all budgets
    front_size: int
    best_quality: Optional[float]
    best_latency_s: Optional[float]   # primary-device minimum on the front

    def to_json(self) -> Dict[str, Any]:
        return {
            "gen": self.gen, "produced": self.produced,
            "new_scored": self.new_scored,
            "predict_calls": self.predict_calls,
            "feasible_new": self.feasible_new,
            "front_size": self.front_size,
            "best_quality": self.best_quality,
            "best_latency_s": self.best_latency_s,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "GenStats":
        return cls(**d)


@dataclass
class FrontMember:
    digest: str
    genotype: Dict[str, Any]            # Genotype.to_json()
    quality: float
    latencies: Dict[str, float]         # setting key → predicted e2e seconds
    objectives: List[float]

    def to_json(self) -> Dict[str, Any]:
        return {"digest": self.digest, "genotype": self.genotype,
                "quality": self.quality, "latencies": self.latencies,
                "objectives": self.objectives}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "FrontMember":
        return cls(digest=d["digest"], genotype=d["genotype"],
                   quality=float(d["quality"]),
                   latencies={k: float(v) for k, v in d["latencies"].items()},
                   objectives=[float(v) for v in d["objectives"]])


@dataclass
class SearchReport:
    """The search's durable output: front + per-generation stats."""

    config: Dict[str, Any]
    budgets: List[Dict[str, Any]]
    generations: int
    candidates_scored: int
    predict_batch_calls: int
    front: List[FrontMember] = field(default_factory=list)
    stats: List[GenStats] = field(default_factory=list)
    wall_time_s: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "config": self.config, "budgets": self.budgets,
            "generations": self.generations,
            "candidates_scored": self.candidates_scored,
            "predict_batch_calls": self.predict_batch_calls,
            "front": [m.to_json() for m in self.front],
            "stats": [s.to_json() for s in self.stats],
            "wall_time_s": self.wall_time_s,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SearchReport":
        """Inverse of `to_json` — lets a serving process (the RPC
        search-front endpoint) load a persisted report without a
        service or engine."""
        return cls(
            config=dict(d["config"]),
            budgets=[dict(b) for b in d["budgets"]],
            generations=int(d["generations"]),
            candidates_scored=int(d["candidates_scored"]),
            predict_batch_calls=int(d["predict_batch_calls"]),
            front=[FrontMember.from_json(m) for m in d.get("front", [])],
            stats=[GenStats.from_json(s) for s in d.get("stats", [])],
            wall_time_s=float(d.get("wall_time_s", 0.0)),
        )

    def front_json(self) -> str:
        """Canonical front serialization (invocation-equality checks)."""
        return json.dumps([m.to_json() for m in self.front], sort_keys=True)

    def verify(self, session: ProfileSession,
               setting: Optional[DeviceSetting] = None) -> Dict[str, Any]:
        """Measure the front through ``session`` (predicted-vs-measured).

        Uses the primary budget device unless ``setting`` overrides.
        Each member costs one whole-graph profiling run — the only
        measurements a search spends, which is what the bench compares
        against measure-everything search.
        """
        if setting is None:
            setting = DeviceBudget.from_json(self.budgets[0]).setting
        from repro_torch.pipeline.store import setting_key
        skey = setting_key(setting)
        if self.front and skey not in self.front[0].latencies:
            raise ValueError(
                f"setting {skey!r} was not among the searched devices "
                f"{sorted(self.front[0].latencies)} — nothing to verify "
                f"predictions against")
        cfg = SearchConfig.from_json(self.config).space()
        rows = []
        for m in self.front:
            g = encoding.decode(genotype_from_json(m.genotype), cfg)
            measured = session.profile_graph(g, setting).e2e_s
            predicted = m.latencies.get(skey)
            rows.append({"digest": m.digest, "predicted_s": predicted,
                         "measured_s": measured})
        errs = [abs(r["predicted_s"] - r["measured_s"]) / max(r["measured_s"], 1e-12)
                for r in rows if r["predicted_s"] is not None]
        return {
            "setting": skey,
            "n_verified": len(rows),
            "mape": float(np.mean(errs)) if errs else float("nan"),
            "rows": rows,
        }


class SearchEngine:
    """Aging evolution over `repro_torch.core.nas_space` genotypes, scored by a
    `LatencyService` under multi-device `DeviceBudget` constraints."""

    def __init__(self, service: Any, budgets: Sequence[DeviceBudget],
                 config: Optional[SearchConfig] = None, *,
                 predictor: Optional[str] = None):
        self.cfg = config or SearchConfig()
        self.space = self.cfg.space()
        self.scorer = LatencyScorer(service, budgets, predictor)
        self.quality_fn = make_quality(self.cfg.quality)
        self.rng = np.random.default_rng(self.cfg.seed)
        self.generation = 0
        self.population: List[str] = []        # digests, oldest first
        self.genotypes: Dict[str, Genotype] = {}
        self.memo: Dict[str, Dict[str, Any]] = {}
        self.front = ParetoFront(self.cfg.front_capacity)
        self.stats: List[GenStats] = []
        self.wall_time_s = 0.0

    # -- seeding --------------------------------------------------------------
    def _seed_genotype(self):
        """One seed draw from the configured genotype family."""
        if self.cfg.family == "random_wired":
            return encoding.random_wired(self.rng, self.cfg.rw_space())
        if self.cfg.family == "elastic":
            return encoding.random_elastic_genotype(self.rng, self.space)
        return encoding.random_genotype(self.rng, self.space)

    # -- scoring --------------------------------------------------------------
    def _register(self, gt: Genotype) -> str:
        d = gt.digest()
        self.genotypes.setdefault(d, gt)
        return d

    def _objectives(self, digest: str) -> List[float]:
        e = self.memo[digest]
        return [e["lat"][k] for k in self.scorer.keys] + [-e["quality"]]

    def _ensure_scored(self, digests: Sequence[str]) -> Tuple[int, int, int]:
        """Score memo-new digests in ONE batch per device setting.

        Returns (new_scored, predict_calls, feasible_new).  Batching only
        the memo-new candidates keeps replays bit-identical: a resumed
        run sends exactly the rows the original run sent, so the
        numpy-vs-device "auto" threshold resolves the same way.
        """
        new = [d for d in dict.fromkeys(digests) if d not in self.memo]
        if not new:
            return 0, 0, 0
        graphs = [encoding.decode(self.genotypes[d], self.space) for d in new]
        lats = self.scorer.score(graphs)
        feas = self.scorer.feasible_mask(lats)
        viol = self.scorer.violation(lats)
        # Genotype-scored proxies (SupernetQuality: weight sharing is
        # defined over knobs, not the flat op list) take the genotype.
        on_genotype = getattr(self.quality_fn, "needs_genotype", False)
        for i, d in enumerate(new):
            q_arg = self.genotypes[d] if on_genotype else graphs[i]
            self.memo[d] = {
                "lat": {k: float(lats[k][i]) for k in self.scorer.keys},
                "quality": float(self.quality_fn(q_arg)),
                "feasible": bool(feas[i]),
                "violation": float(viol[i]),
            }
        return len(new), len(self.scorer.budgets), int(np.sum(feas))

    # -- parent selection -----------------------------------------------------
    def _selection_order(self) -> List[int]:
        """Rank every population slot by crowded-comparison fitness.

        Returns, per slot, its position in the fitness order (lower is
        fitter): feasible before infeasible; feasible slots by
        (Pareto rank asc, crowding desc); infeasible by violation asc.
        Ties break on the slot index, so selection is deterministic.
        """
        pop = self.population
        feas = np.array([self.memo[d]["feasible"] for d in pop])
        viol = np.array([self.memo[d]["violation"] for d in pop])
        pts = np.array([self._objectives(d) for d in pop])
        ranks = np.full(len(pop), np.inf)
        crowd = np.zeros(len(pop))
        if feas.any():
            fidx = np.flatnonzero(feas)
            r = nondominated_rank(pts[fidx])
            ranks[fidx] = r
            for level in np.unique(r):
                lidx = fidx[r == level]
                crowd[lidx] = crowding_distance(pts[lidx])
        keyed = sorted(
            range(len(pop)),
            key=lambda i: ((0, ranks[i], -crowd[i], i) if feas[i]
                           else (1, viol[i], 0.0, i)))
        fitness = np.empty(len(pop), dtype=np.intp)
        for pos, i in enumerate(keyed):
            fitness[i] = pos
        return list(fitness)

    def _tournament(self, fitness: Sequence[int]) -> str:
        k = min(self.cfg.tournament_size, len(self.population))
        idx = self.rng.integers(0, len(self.population), size=k)
        best = min(idx, key=lambda i: (fitness[i], i))
        return self.population[int(best)]

    # -- the loop -------------------------------------------------------------
    def step(self) -> GenStats:
        """One generation (generation 0 seeds the population)."""
        t0 = time.perf_counter()
        if self.generation == 0 and not self.population:
            while len(self.population) < self.cfg.population_size:
                gt = self._seed_genotype()
                self.population.append(self._register(gt))
            produced = list(self.population)
        else:
            fitness = self._selection_order()
            children: List[str] = []
            for _ in range(self.cfg.children_per_gen):
                if (len(self.population) >= 2
                        and self.rng.random() < self.cfg.crossover_prob):
                    a = self.genotypes[self._tournament(fitness)]
                    b = self.genotypes[self._tournament(fitness)]
                    child = encoding.crossover(a, b, self.rng, self.space)
                    child = encoding.mutate(child, self.rng, self.space)
                else:
                    parent = self.genotypes[self._tournament(fitness)]
                    child = encoding.mutate(parent, self.rng, self.space)
                children.append(self._register(child))
            produced = children
        new_scored, predict_calls, feasible_new = self._ensure_scored(produced)
        for d in dict.fromkeys(produced):
            if self.memo[d]["feasible"]:
                self.front.add(d, self._objectives(d))
        if self.generation > 0:
            self.population.extend(produced)
            overflow = len(self.population) - self.cfg.population_size
            if overflow > 0:
                del self.population[:overflow]     # age out the oldest
        best_q = best_lat = None
        if len(self.front):
            pts = self.front.objectives()
            best_lat = float(pts[:, 0].min())
            best_q = float(-pts[:, -1].min())
        stats = GenStats(
            gen=self.generation, produced=len(produced),
            new_scored=new_scored, predict_calls=predict_calls,
            feasible_new=feasible_new, front_size=len(self.front),
            best_quality=best_q, best_latency_s=best_lat,
        )
        self.stats.append(stats)
        self.generation += 1
        self.wall_time_s += time.perf_counter() - t0
        log.info("gen %d: %d produced, %d new scored, front %d "
                 "(best lat %.3g s, best quality %.3g)",
                 stats.gen, stats.produced, stats.new_scored,
                 stats.front_size,
                 best_lat if best_lat is not None else float("nan"),
                 best_q if best_q is not None else float("nan"))
        return stats

    def run(self, *, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0) -> SearchReport:
        """Run to ``config.generations`` steps; optionally checkpoint."""
        while self.generation < self.cfg.generations:
            self.step()
            if (checkpoint_path and checkpoint_every
                    and self.generation % checkpoint_every == 0):
                self.save(checkpoint_path)
        if checkpoint_path:
            self.save(checkpoint_path)
        return self.report()

    # -- output ---------------------------------------------------------------
    def report(self) -> SearchReport:
        front_members = []
        for digest, obj, _ in self.front.members():
            e = self.memo[digest]
            front_members.append(FrontMember(
                digest=digest,
                genotype=self.genotypes[digest].to_json(),
                quality=e["quality"],
                latencies=dict(e["lat"]),
                objectives=[float(v) for v in obj],
            ))
        return SearchReport(
            config=self.cfg.to_json(),
            budgets=[b.to_json() for b in self.scorer.budgets],
            generations=self.generation,
            candidates_scored=len(self.memo),
            predict_batch_calls=self.scorer.predict_batch_calls,
            front=front_members,
            stats=list(self.stats),
            wall_time_s=self.wall_time_s,
        )

    # -- checkpointing --------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the full search state as JSON (atomic replace)."""
        state = {
            "version": CHECKPOINT_VERSION,
            "config": self.cfg.to_json(),
            "budgets": [b.to_json() for b in self.scorer.budgets],
            "predictor": self.scorer.predictor,
            "generation": self.generation,
            "rng_state": self.rng.bit_generator.state,
            "population": list(self.population),
            "genotypes": {d: gt.to_json() for d, gt in self.genotypes.items()},
            "memo": self.memo,
            "front": self.front.to_json(),
            "stats": [s.to_json() for s in self.stats],
            "predict_batch_calls": self.scorer.predict_batch_calls,
            "wall_time_s": self.wall_time_s,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str, service: Any) -> "SearchEngine":
        """Rebuild an engine mid-search; continuing it replays the exact
        trajectory the uninterrupted run would have taken (the rng state,
        score memo, population, and front are all restored)."""
        with open(path) as f:
            state = json.load(f)
        if state.get("version") != CHECKPOINT_VERSION:
            raise ValueError(
                f"unsupported search checkpoint version {state.get('version')!r}")
        cfg = SearchConfig.from_json(state["config"])
        budgets = [DeviceBudget.from_json(b) for b in state["budgets"]]
        eng = cls(service, budgets, cfg, predictor=state.get("predictor"))
        eng.generation = int(state["generation"])
        eng.rng.bit_generator.state = state["rng_state"]
        eng.population = list(state["population"])
        eng.genotypes = {d: genotype_from_json(g)
                         for d, g in state["genotypes"].items()}
        eng.memo = dict(state["memo"])
        eng.front = ParetoFront.from_json(state["front"])
        eng.stats = [GenStats.from_json(s) for s in state["stats"]]
        eng.scorer.predict_batch_calls = int(state.get("predict_batch_calls", 0))
        eng.wall_time_s = float(state.get("wall_time_s", 0.0))
        return eng
