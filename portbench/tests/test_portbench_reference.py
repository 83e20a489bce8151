"""Each family's plain reference against the port's own CPU path at a
reduced size, in float32: the same loss and gradients for the same
weights and batch, and the same readings over the check steps.  (The
test imports both; the reference itself imports nothing of the port.)"""
import pytest
import torch

from portbench import core
from portbench.drivers import train
from portbench.reference import _plain
from portbench.tests._tiny import tiny_cell

SEED = 2 ** 31 + 977


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_loss_and_gradients_match_the_ports(family):
    cell = tiny_cell(family)
    arch = cell.config["arch"]
    device = torch.device("cpu")
    model, state, _ = train.build(cell, SEED, device)
    batch = train.Feed(cell, SEED, device)(0)
    from repro_torch.utils.tree import flatten_with_paths

    port_loss, _ = model.loss(state.params, batch)
    leaves = flatten_with_paths(state.params)
    port_grads = dict(zip(leaves, torch.autograd.grad(port_loss, list(leaves.values()))))

    ref = core.module("reference", family)
    tree = _plain.weights(ref.groups(arch), SEED, device)
    flat = _plain.flatten(tree)
    assert sorted(flat) == sorted(leaves)
    for v in flat.values():
        v.requires_grad_(True)
    ref_loss = ref.loss(tree, batch, arch)
    ref_grads = dict(zip(flat, torch.autograd.grad(ref_loss, list(flat.values()))))

    assert float(port_loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    for k, g in ref_grads.items():
        scale = float(g.abs().max()) or 1.0
        assert float((port_grads[k] - g).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_check_step_readings_match_the_ports(family):
    from portbench import calibrate

    cell = tiny_cell(family)
    device = torch.device("cpu")
    gaps = train.gaps(calibrate.program_readings(cell, SEED, device),
                      train.reference_readings(cell, SEED, device))
    for name in ("loss_gap", "grad_norm_gap", "grad_norm_gap_median", "change_gap"):
        assert gaps[name] < 1e-5, (name, gaps)


def test_adamw_matches_the_ports():
    from repro_torch.optim.adamw import adamw_init, adamw_update

    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 3, generator=gen), "b": torch.randn(7, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    job = core.load_json("workloads", "granite-moe-1b.train.4x4096")["job"]
    ref = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in ref.items()}
    nu = {k: torch.zeros_like(v) for k, v in ref.items()}
    state = adamw_init(params)
    for step in range(3):
        lr = _plain.learning_rate(step + 100, job, "cpu")
        _plain.adamw(ref, grads, mu, nu, step, dict(job, warmup_steps=0, total_steps=10 ** 6,
                                                     base_lr=float(lr)))
        params, state, _ = adamw_update(grads, state, params, lr=lr,
                                        weight_decay=job["weight_decay"])
    for k in params:
        torch.testing.assert_close(params[k], ref[k], rtol=1e-6, atol=1e-7)


def test_the_schedule_matches_the_ports():
    from repro_torch.optim.schedules import linear_warmup_cosine

    job = core.load_json("workloads", "granite-moe-1b.train.4x4096")["job"]
    for step in (0, 1, 2, 99, 100, 101, 5000, 9999, 20000):
        port = linear_warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                    base_lr=job["base_lr"], warmup_steps=job["warmup_steps"],
                                    total_steps=job["total_steps"])
        assert float(_plain.learning_rate(step, job, "cpu")) == pytest.approx(
            float(port), rel=1e-6, abs=1e-12)


def test_the_traffic_is_the_ports_generator_frozen():
    import numpy as np
    from repro_torch.data.pipeline import SyntheticLMData

    from portbench.traffic import TokenTraffic

    mix = core.load_json("traffic", "lm.2x2048")
    ours = TokenTraffic(mix, 50280, SEED)
    port = SyntheticLMData(vocab_size=50280, seq_len=mix["seq"], global_batch=mix["batch"],
                           seed=SEED)
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), port.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(ours.batch_at(0)["tokens"], ours.batch_at(1)["tokens"])


def test_the_published_drop_differs_only_where_pairs_are_dropped():
    """``overflow: "drop"`` (read by `calibrate.py` only) changes the MoE
    reference's loss where capacity drops pairs, and not where none is
    dropped."""
    moe = core.module("reference", "moe")
    cell = tiny_cell("moe")
    device = torch.device("cpu")
    batch = train.Feed(cell, SEED, device)(0)
    for factor, differs in ((0.5, True), (8.0, False)):
        arch = dict(cell.config["arch"], capacity_factor=factor)
        tree = _plain.weights(moe.groups(arch), SEED, device)
        ours = float(moe.loss(tree, batch, arch))
        published = float(moe.loss(tree, batch, dict(arch, overflow="drop")))
        assert (ours != published) == differs, (factor, ours, published)
