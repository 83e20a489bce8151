"""The port's serving driver (repro_torch.launch.serve) against the
reference's (repro.launch.serve), on the host.

For each LM family (dense Qwen2, MoE Granite, SSM Mamba2, hybrid Zamba2,
the VLM, Whisper), reduced and in float32 compute, the reference's own
`main` runs under the same flags with its model and parameters swapped
for the test's (the reference's initial parameters, the VLM's zero gates
set to `GATE`), and `serve` runs the port's model on the same parameters
carried across by `convert.lm_params_from_reference`.  Both get the
driver's zero bfloat16 extras (the VLM's vision embeddings, Whisper's
encoder memory) and its ``default_rng(seed)`` prompts.  The finished
requests must be the same, in the same order, with the same greedy
tokens, exactly.

Both decode with float32 caches (the K/V caches; Mamba's states are
float32 already): with a bfloat16 cache a key within float32 rounding of
a bfloat16 boundary rounds the other way in the other package and can
flip a greedy token (tests/test_torch_serving.py).  The reference's
Whisper cache is bfloat16 whatever the compute type, so its float32 one
is built here in the reference's layout.
"""
import dataclasses
import logging
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.serving import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, encdec, transformer  # noqa: E402

# One intra-op thread per xdist worker's share of the cores: these tests
# run beside the reference's wall-clock profiling tests.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCHS = ["qwen2-72b", "granite-moe-1b-a400m", "mamba2-2.7b", "zamba2-1.2b",
         "llama-3.2-vision-90b", "whisper-large-v3"]
GATE = 0.7
# More requests than slots, so freed slots are taken again.
FLAGS = ["--requests", "6", "--prompt-len", "8", "--max-new", "8", "--slots", "4",
         "--max-len", "96", "--seed", "3"]
SERVED = re.compile(r"served (\d+)/(\d+) requests, (\d+) tokens in [\d.]+s "
                    r"\([\d.]+ tok/s\)")


def _ref_cache(rcfg, rm, b, n):
    """The reference's decode cache with float32 K/V arrays."""
    if rcfg.family in ("dense", "moe", "vlm"):
        return rtf.init_cache(rcfg, b, n, "float32")
    cache = rm.init_cache(b, n)
    if rcfg.family == "encdec":
        return {k: v.astype(jnp.float32) if k in ("k", "v") else v
                for k, v in cache.items()}
    if rcfg.family == "hybrid":
        cache["attn"]["k"] = jnp.zeros(cache["attn"]["k"].shape, jnp.float32)
        cache["attn"]["v"] = jnp.zeros(cache["attn"]["v"].shape, jnp.float32)
    return cache


def _port_cache(cfg, m, b, n, device):
    """The port's decode cache with float32 K/V tensors."""
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.init_cache(cfg, b, n, "float32", device=device)
    if cfg.family == "encdec":
        return encdec.init_encdec_cache(cfg, b, n, "float32", device=device)
    cache = m.init_cache(b, n, device=device)
    if cfg.family == "hybrid":
        cache["attn"]["k"] = torch.zeros(cache["attn"]["k"].shape, device=device)
        cache["attn"]["v"] = torch.zeros(cache["attn"]["v"].shape, device=device)
    return cache


def _models(arch):
    rcfg = dataclasses.replace(rget(arch).reduced(), compute_dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32")
    rm0, m0 = rbuild(rcfg), build_model(cfg)
    rp = rm0.init(jax.random.PRNGKey(1))
    if rcfg.cross_attn_every:
        rp["cross_layers"]["gate"] = jnp.full_like(rp["cross_layers"]["gate"], GATE)
    p = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                 device="cpu")
    rm = dataclasses.replace(rm0, init=lambda key: rp,
                             init_cache=lambda b, n: _ref_cache(rcfg, rm0, b, n))
    m = dataclasses.replace(m0, init_cache=lambda b, n, device: _port_cache(
        cfg, m0, b, n, device))
    return rcfg, cfg, rm, m, p


def _reference_main(monkeypatch, rcfg, rm, argv):
    """The reference driver's `main` under ``argv``, on ``rm``; returns the
    requests its engine finished."""
    runs = []

    class Recording(RefEngine):
        def run(self, *a, **kw):
            runs.append(super().run(*a, **kw))
            return runs[-1]

    monkeypatch.setattr(rserve, "ServeEngine", Recording)
    monkeypatch.setattr(rserve, "get_arch", lambda name: rcfg)
    monkeypatch.setattr(rserve, "build_model", lambda cfg: rm)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    rserve.main()
    (done,) = runs
    return done


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_the_reference_driver(monkeypatch, arch):
    rcfg, cfg, rm, m, p = _models(arch)
    argv = ["--arch", cfg.name] + FLAGS
    want = _reference_main(monkeypatch, rcfg, rm, argv)
    got = serve.serve(m, p, serve.parse_args(argv + ["--device", "cpu"]))
    assert len(got) == len(want) == 6
    assert [r.uid for r in got] == [r.uid for r in want]
    rng = np.random.default_rng(3)
    for r, w in zip(got, want):
        np.testing.assert_array_equal(r.prompt, rng.integers(0, cfg.vocab_size, size=8))
        np.testing.assert_array_equal(r.prompt, w.prompt)
        assert r.generated == w.generated and len(r.generated) == 8


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m-reduced",
                                  "whisper-large-v3-reduced"])
def test_main_serves_on_the_host_and_logs_the_reference_line(caplog, arch):
    """`main` builds the model from the port's own init and logs the
    reference's lines: every request answered, max_new tokens each."""
    # The port's loggers write to their own handler and do not propagate.
    logging.getLogger("repro").addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="repro"):
            done = serve.main(["--arch", arch, "--requests", "5", "--prompt-len", "4",
                               "--max-new", "3", "--slots", "2", "--device", "cpu"])
    finally:
        logging.getLogger("repro").removeHandler(caplog.handler)
    assert len(done) == 5 and all(len(r.generated) == 3 for r in done)
    assert all(0 <= t < get_arch(arch).vocab_size for r in done for t in r.generated)
    lines = [SERVED.search(r.getMessage()) for r in caplog.records]
    (served,) = [x for x in lines if x]
    assert served.groups() == ("5", "5", "15")
    assert sum(r.getMessage().startswith("req ") for r in caplog.records) == 3
