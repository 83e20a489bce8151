"""The port's collective accounting (`repro_torch.utils.hlo_analysis`)
against the reference's record and against closed forms.

* `CollectiveStats` is the reference's copy: the same dicts give the same
  ``summary()``, ``total_bytes`` and ``total_count``.
* On a fake process group of 8 ranks (in a subprocess: the group is
  process-global), each ``torch.distributed`` call and functional
  collective inside `collect_collective_stats` is recorded under its kind
  with its result bytes and one call, exactly: the closed form of each
  case below (float32, 4 bytes an element).  A ``wait_tensor`` adds
  nothing; a DTensor's ``full_tensor`` is one all-gather of the whole
  tensor; a recv adds nothing (its bytes are its sender's).
* A collective with no kind (``reduce``) raises `UnmappedCollective`.
* `count_op` counts ATen ops by name, ``bytes_accessed`` sums operand and
  result bytes of the ops that are not views, and
  `cpu_bf16_upcast_bytes` is 0.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.utils.hlo_analysis import CollectiveStats as RefStats  # noqa: E402
from repro.utils.hlo_analysis import COLLECTIVE_KINDS as REF_KINDS  # noqa: E402
from repro_torch.utils.hlo_analysis import (  # noqa: E402
    COLLECTIVE_KINDS, CollectiveStats, collect_collective_stats, count_op,
    cpu_bf16_upcast_bytes,
)

SRC = str(Path(__file__).resolve().parents[1] / "src")


def run_fake_world(body: str, timeout: int = 240) -> dict:
    """Run ``body`` in a fresh process on a fake group of 8 ranks; it
    prints one JSON line, returned parsed."""
    code = textwrap.dedent("""
        import json
        import torch
        import torch.distributed as dist
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.utils.hlo_analysis import collect_collective_stats
        torch.set_num_threads(1)
        W = 8
    """) + textwrap.dedent(body)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collective_stats_is_the_references():
    assert COLLECTIVE_KINDS == REF_KINDS
    cases = [({}, {}),
             ({"all-reduce": 64, "all-gather": 512}, {"all-reduce": 2, "all-gather": 1}),
             ({"collective-permute": 40}, {"collective-permute": 3})]
    for by_bytes, by_count in cases:
        ours = CollectiveStats(dict(by_bytes), dict(by_count), [("all-reduce", 8)])
        ref = RefStats(dict(by_bytes), dict(by_count), [("all-reduce", 8)])
        assert ours.summary() == ref.summary()
        assert (ours.total_bytes, ours.total_count) == (ref.total_bytes, ref.total_count)


def test_each_kind_counts_its_result_bytes_once_on_a_fake_group():
    got = run_fake_world("""
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor

        out = {}

        def case(name, fn):
            with collect_collective_stats() as tr:
                fn()
            out[name] = tr.stats.summary()

        def p2p():
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, torch.ones(10), 1),
                dist.P2POp(dist.irecv, torch.empty(10), W - 1)])
            for r in reqs:
                r.wait()

        with fake_world(W):
            g = dist.group.WORLD
            t = torch.ones(16)
            case("all_reduce", lambda: dist.all_reduce(t))
            case("all_gather", lambda: dist.all_gather([torch.empty(16) for _ in range(W)], t))
            case("all_gather_into_tensor",
                 lambda: dist.all_gather_into_tensor(torch.empty(16 * W), t))
            case("reduce_scatter", lambda: dist.reduce_scatter(
                torch.empty(16), [torch.ones(16) for _ in range(W)]))
            case("reduce_scatter_tensor",
                 lambda: dist.reduce_scatter_tensor(torch.empty(16), torch.ones(16 * W)))
            case("all_to_all_single",
                 lambda: dist.all_to_all_single(torch.empty(16 * W), torch.ones(16 * W)))
            case("all_to_all", lambda: dist.all_to_all(
                [torch.empty(16) for _ in range(W)], [torch.ones(16) for _ in range(W)]))
            case("broadcast", lambda: dist.broadcast(t, src=0))
            case("send_recv", p2p)
            case("funcol_all_reduce", lambda: funcol.all_reduce(t, "sum", g) * 1)
            case("funcol_all_gather", lambda: funcol.all_gather_tensor(t, 0, g) * 1)
            case("funcol_reduce_scatter",
                 lambda: funcol.reduce_scatter_tensor(torch.ones(16 * W), "sum", 0, g) * 1)
            mesh = init_device_mesh("cpu", (W,))
            dt = distribute_tensor(torch.ones(64, 4), mesh, [Shard(0)])
            case("full_tensor", lambda: dt.full_tensor())
            try:
                case("reduce", lambda: dist.reduce(t, dst=0))
            except Exception as e:
                out["reduce"] = type(e).__name__
        print(json.dumps(out))
    """)
    one = lambda kind, nbytes: {kind: {"bytes": nbytes, "count": 1}}  # noqa: E731
    want = {
        "all_reduce": one("all-reduce", 64),
        "all_gather": one("all-gather", 8 * 64),
        "all_gather_into_tensor": one("all-gather", 8 * 64),
        "reduce_scatter": one("reduce-scatter", 64),
        "reduce_scatter_tensor": one("reduce-scatter", 64),
        "all_to_all_single": one("all-to-all", 8 * 64),
        "all_to_all": one("all-to-all", 8 * 64),
        "broadcast": one("all-reduce", 64),
        "send_recv": one("collective-permute", 40),
        "funcol_all_reduce": one("all-reduce", 64),
        "funcol_all_gather": one("all-gather", 8 * 64),
        "funcol_reduce_scatter": one("reduce-scatter", 64),
        "full_tensor": one("all-gather", 64 * 4 * 4),
        "reduce": "UnmappedCollective",
    }
    assert got == want


def test_op_counts_bytes_and_no_upcast():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with collect_collective_stats() as tr:
        c = a @ b
        d = c.t()                      # a view: no bytes
        e = d + 1
    assert count_op(tr, "mm") == 1 and count_op(tr, "add") == 1 and count_op(tr, "bmm") == 0
    assert tr.bytes_accessed == (8 * 16 + 16 * 4 + 8 * 4) * 4 + (4 * 8) * 4 * 2
    assert tr.stats.summary() == {} and e.shape == (4, 8)
    assert cpu_bf16_upcast_bytes(tr) == 0
