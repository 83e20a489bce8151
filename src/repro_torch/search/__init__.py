"""Hardware-aware NAS driven by the latency predictor (docs/PIPELINE.md
§ "NAS search"), on the port's `LatencyService`.

The paper's motivating workload as a real search engine: an aging
evolutionary loop over `repro_torch.core.nas_space` genotypes whose latency
objective is served entirely by `LatencyService.predict_batch` (one
batched call per device setting per generation) under per-device budget
constraints, with an incremental Pareto front, JSON checkpoint/resume,
and measured verification of the final front:

    encoding    — mutate/crossover/repair over `Genotype`s + decode
    objectives  — quality proxies, `DeviceBudget`, `LatencyScorer`
    pareto      — incremental non-dominated front, crowding distance
    evolution   — `SearchEngine`, `SearchConfig`, `SearchReport`

Three genotype families share the loop (`SearchConfig.family`): the
paper's block chains, OFA-style elastic chains (shrink/grow knob steps,
`SupernetQuality` weight-sharing proxy), and random-wired DAGs
(WS/ER/BA samplers, stage-wise recombination).

Port notes (twin of the reference's ``repro.search``): the modules are
copies with only their import paths changed, so a search given the same
bank replays the reference's trajectory bit for bit on the numpy tier.
On the card each generation's ``predict_batch`` runs the fused tree
kernel once per op type, and `SearchReport.verify` measures the front
with the port's `ProfileSession`.
"""
from repro_torch.search.encoding import (crossover, decode, grow, mutate,
                                         mutate_elastic, mutate_random_wired,
                                         random_elastic_genotype, random_genotype,
                                         random_wired, repair, repair_random_wired,
                                         shrink)
from repro_torch.search.evolution import (FrontMember, GenStats, SearchConfig,
                                          SearchEngine, SearchReport)
from repro_torch.search.objectives import (BalancedQuality, DeviceBudget,
                                           FlopsQuality, LatencyScorer, QUALITIES,
                                           SupernetQuality, graph_flops,
                                           graph_params, make_quality)
from repro_torch.search.pareto import (ParetoFront, crowding_distance, dominates,
                                       nondominated_rank)

__all__ = [
    "BalancedQuality", "DeviceBudget", "FlopsQuality", "FrontMember",
    "GenStats",
    "LatencyScorer", "ParetoFront", "QUALITIES", "SearchConfig",
    "SearchEngine", "SearchReport", "SupernetQuality", "crossover",
    "crowding_distance",
    "decode", "dominates", "graph_flops", "graph_params", "grow",
    "make_quality",
    "mutate", "mutate_elastic", "mutate_random_wired", "nondominated_rank",
    "random_elastic_genotype", "random_genotype", "random_wired", "repair",
    "repair_random_wired", "shrink",
]
