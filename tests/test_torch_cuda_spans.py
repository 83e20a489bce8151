"""The training step's spans on the card (`repro_torch.obs.tracing`):
Granite-MoE and Mamba2 at their published widths, cut to 2 layers, one
step under torch.profiler.

Marked ``cuda``: these tests need an NVIDIA card and nvcc (the kernels
are built at first use), and skip elsewhere.  On a machine with the
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_spans.py

Every span launches work on the card and the profiler gives it that
device time, except ``train.backward``: autograd runs the backward on a
thread of its own, where the spans under it (the recompute, the ``.bwd``
spans) take the kernels.  A traced step waits for the card no more often
than an untraced one (`torch.cuda.set_sync_debug_mode`).
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ARCHS = ["granite-moe-1b-a400m", "mamba2-2.7b"]
BATCH, SEQ = 2, 1024


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _setup(arch, card):
    from repro_torch.configs import get_arch
    from repro_torch.distributed import init_train_state, make_train_step
    from repro_torch.models import build_model

    m = build_model(dataclasses.replace(get_arch(arch), num_layers=2))
    state = init_train_state(m, 0, device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    batch = {k: torch.randint(0, m.cfg.vocab_size, (BATCH, SEQ), generator=gen,
                              device=card, dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(m)
    state, _ = step(state, batch)            # builds the kernels
    torch.cuda.synchronize()
    return step, state, batch


def _syncs(step, state, batch):
    """The step's synchronizing calls, counted by the sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return state, sum("synchroniz" in str(w.message) for w in seen)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_span_has_device_time_and_no_sync_is_added(card, arch):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    step, state, batch = _setup(arch, card)
    state, untraced = _syncs(step, state, batch)
    before = len(obs.default().tracer.export())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, traced = _syncs(step, state, batch)
    names = {s["name"] for s in obs.default().tracer.export()[before:]}
    assert {"train.step", "train.forward", "train.backward", "train.optimizer",
            "train.sync", "lm.head", "lm.head.bwd"} <= names
    device_us = {}
    for e in prof.events():
        if e.name in names:
            assert not e.is_user_annotation, e.name
            device_us[e.name] = device_us.get(e.name, 0.0) + e.device_time_total
    assert set(device_us) == names
    assert all(us > 0 for n, us in device_us.items() if n != "train.backward"), device_us
    assert traced <= untraced, (traced, untraced)
