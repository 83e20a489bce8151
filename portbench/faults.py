"""Faults planted under the port's training step, for the check that
`correct` catches them (`tests/test_portbench_faults.py`) and for reading
what they do at a cell's own size (`calibrate.py`).  Each takes the step
and returns the broken step."""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

Step = Callable[[Any, Dict[str, torch.Tensor]], Any]


def _leaves(state):
    from repro_torch.utils.tree import flatten_with_paths

    return flatten_with_paths(state.params)


def unchanged(step: Step) -> Step:
    """The step computes, then returns its state as it was."""
    def broken(state, batch):
        tensors = [*_leaves(state).values(), *state.opt.mu.values(), *state.opt.nu.values()]
        saved = [t.detach().clone() for t in tensors]
        _, metrics = step(state, batch)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return state, metrics
    return broken


def half_batch(step: Step) -> Step:
    """Half of the batch's rows left out; the loss is the mean over the rest."""
    def broken(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return broken


def answer_altered(step: Step) -> Step:
    """The first leaf's update (in path order) is applied twice."""
    def broken(state, batch):
        leaf = next(iter(_leaves(state).values()))
        before = leaf.detach().clone()
        state, metrics = step(state, batch)
        with torch.no_grad():
            leaf.add_(leaf - before)
        return state, metrics
    return broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
