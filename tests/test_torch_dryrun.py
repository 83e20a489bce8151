"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
(`repro.launch.dryrun`) and against real runs, on the host.

* `Model.input_specs` and `shape_applicable` equal the reference's, shapes
  and dtypes, for every arch × shape.
* `resolve_variant` follows its stated derivation for an 80 GB card (the
  reference's fractions of its 16 GB chip); the cells where it differs
  from the reference's are listed in `VARIANT_DIFFERS`.
* `run_cell` on the reference's test cell (reduced Granite × train_4k on a
  (2, 4) mesh), traced on a fake group of 8 ranks, gives the reference's
  record keys (its own `run_cell` on the same cell, in a jax subprocess
  with 8 host devices), ``ok``, FLOPs > 0 and temp > 0.
* Fake mode against real runs, on a reduced train cell (Granite reduced,
  32 × 64 tokens, 16 microbatches): on one process, the traced FLOPs and
  memory record (arguments, outputs, aliases, temp) equal the real CPU
  run's exactly; on a (2, 2) mesh, rank 0's collective bytes and counts
  per kind, FLOPs and memory record equal those of 4 real gloo ranks
  exactly.
* One reduced cell per family (MoE, Mamba2, Zamba2, VLM, Whisper), one
  prefill and one decode cell trace on a fake (2, 4) mesh.
* Decode on a mesh (gloo, (2, 2)) gives the one-process logits within
  1e-5 of their largest magnitude in float32, three steps from a filled
  float32 cache: a K/V cache cut along its sequence (reduced qwen2: one kv
  head) and along its kv heads (reduced Granite, Zamba2's shared block,
  Whisper), and Mamba2's state cut along its head dim.
* The same five families decode on the (2, 2) mesh from the reference's
  parameters and filled float32 cache, carried over, and give the
  reference's jitted `decode_step` logits on the same tokens (and
  Whisper's memory) within 1e-5 of their largest magnitude, three steps;
  the filled length (14 of 32) puts qwen2's new keys on both sides of its
  cache's sequence cut.

Fake groups are process-global, so every fake-group trace runs in a
subprocess, as the reference's mesh tests do.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.configs import shape_applicable as ref_applicable  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES, InputShape, get_arch, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.hlo_analysis import COLLECTIVE_KINDS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TOL = 1e-5
# A reduced train cell that a real host run can take: 32 × 64 tokens, 16
# microbatches of 2 rows.
SMALL_TRAIN = InputShape("train_4k", 64, 32, "train")

# (arch, shape) → (the reference's variant, the port's): its thresholds
# are 15e9 parameters and 6e9 bf16 bytes a chip, the port's 75e9 and 30e9.
VARIANT_DIFFERS = {
    ("deepseek-67b", "train_4k"): ("fsdp", "tp"),
    ("gemma2-27b", "train_4k"): ("fsdp", "tp"),
    ("qwen2-72b", "train_4k"): ("fsdp", "tp"),
    ("starcoder2-15b", "train_4k"): ("fsdp", "tp"),
    ("deepseek-67b", "decode_32k"): ("fsdp", "tp"),
    ("llama-3.2-vision-90b", "decode_32k"): ("fsdp", "tp"),
    ("qwen2-72b", "decode_32k"): ("fsdp", "tp"),
    ("qwen3-moe-235b-a22b", "decode_32k"): ("fsdp", "tp"),
    # long_500k is a decode shape too (the full-attention archs skip it).
    ("deepseek-67b", "long_500k"): ("fsdp", "tp"),
    ("llama-3.2-vision-90b", "long_500k"): ("fsdp", "tp"),
    ("qwen2-72b", "long_500k"): ("fsdp", "tp"),
    ("qwen3-moe-235b-a22b", "long_500k"): ("fsdp", "tp"),
}


def _run(code: str, timeout: int = 600, xla_devices: int = 0) -> str:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    if xla_devices:
        code = (f"import os\nos.environ['XLA_FLAGS'] = "
                f"'--xla_force_host_platform_device_count={xla_devices}'\n") + code
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    """The reference's record of its test cell and its variants of every cell."""
    out = _run(textwrap.dedent("""
        import json
        from repro.configs import ARCHS, INPUT_SHAPES, get_arch
        from repro.launch.dryrun import resolve_variant, run_cell
        from repro.launch.mesh import make_mesh

        mesh = make_mesh((2, 4), ("data", "model"))
        rec = run_cell("granite-moe-1b-a400m", "train_4k", mesh,
                       cfg_override=get_arch("granite-moe-1b-a400m").reduced())
        rec.pop("traceback", None)
        variants = {f"{a}|{s}": resolve_variant(get_arch(a), INPUT_SHAPES[s], "auto")
                    for a in ARCHS for s in INPUT_SHAPES}
        print(json.dumps({"record": rec, "variants": variants}))
    """), xla_devices=8)
    return _last_json(out)


# -- specs and variants --------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_and_applicability_are_the_references(arch):
    ours, ref = build_model(get_arch(arch)), rbuild(rget(arch))
    for name, shape in INPUT_SHAPES.items():
        assert shape_applicable(get_arch(arch), shape) == \
            ref_applicable(rget(arch), REF_SHAPES[name])
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in ours.input_specs(shape).items()}
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in ref.input_specs(REF_SHAPES[name]).items()}
        assert got == want and list(got) == list(want), (arch, name)


def test_variant_thresholds_follow_their_derivation(reference):
    # State of 16 bytes a parameter over 16 model ranks: N bytes a card;
    # ZeRO-3 at 15/16 of the card, as the reference at 15e9 of 16 GB.
    assert dryrun.FSDP_PARAM_THRESHOLD == pytest.approx(dryrun.CARD_BYTES * 15 / 16)
    # Weight streaming past 0.375 of the card, as the reference's 6e9 of 16 GB.
    assert dryrun.SERVE_STREAM_THRESHOLD == pytest.approx(dryrun.CARD_BYTES * 6 / 16)
    differs = {}
    for arch in ARCHS:
        cfg = get_arch(arch)
        for name, shape in INPUT_SHAPES.items():
            n = cfg.num_params()
            if shape.kind == "train":
                want = "fsdp" if n * 16 / 16 >= dryrun.CARD_BYTES * 15 / 16 else "tp"
            elif shape.is_decode:
                want = "fsdp" if n * 2 / 16 > dryrun.CARD_BYTES * 6 / 16 else "tp"
            else:
                want = "tp"
            got = dryrun.resolve_variant(cfg, shape, "auto")
            assert got == want and dryrun.resolve_variant(cfg, shape, "fsdp") == "fsdp"
            ref = reference["variants"][f"{arch}|{name}"]
            if ref != got:
                differs[(arch, name)] = (ref, got)
    assert differs == VARIANT_DIFFERS


# -- the record ----------------------------------------------------------------

FAKE_CELLS = """
import json
import torch
from repro_torch.configs import get_arch, InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
torch.set_num_threads(1)
out = {}
with dryrun.fake_world(WORLD):
    mesh = make_mesh(SHAPE, AXES, device_type="cpu")
    for key, arch, shape, small in CELLS:
        cfg = get_arch(arch).reduced()
        rec = dryrun.run_cell(arch, shape, mesh, cfg_override=cfg, device="cpu",
                              shape_override=InputShape(shape, *small) if small else None)
        rec.pop("traceback", None)
        out[key] = rec
print(json.dumps(out))
"""


def _fake_cells(world, shape, axes, cells, timeout=600):
    code = (f"WORLD = {world}\nSHAPE = {shape!r}\nAXES = {axes!r}\nCELLS = {cells!r}\n"
            + FAKE_CELLS)
    return _last_json(_run(code, timeout=timeout))


def test_run_cell_gives_the_references_record_on_a_fake_mesh(reference):
    rec = _fake_cells(8, (2, 4), ("data", "model"),
                      [("cell", "granite-moe-1b-a400m", "train_4k", None)])["cell"]
    ref = reference["record"]
    assert ref["ok"] and rec["ok"], rec.get("error")
    assert set(ref) <= set(rec), set(ref) - set(rec)
    assert set(rec["memory"]) == set(ref["memory"]) and set(rec["cost"]) == set(ref["cost"])
    assert rec["mesh"] == ref["mesh"] == {"data": 2, "model": 4}
    assert rec["microbatches"] == ref["microbatches"] == 16
    assert rec["variant"] == ref["variant"]
    assert rec["cost"]["flops_per_device"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert set(rec["collectives"]) <= set(COLLECTIVE_KINDS)
    assert rec["collective_bytes"] == sum(v["bytes"] for v in rec["collectives"].values()) > 0
    # The step updates parameters and both moments in place (donation).
    assert 0 < rec["memory"]["alias_bytes"] <= rec["memory"]["argument_bytes"]


def test_fake_mode_equals_a_real_run_on_one_process():
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    recs = [dryrun.run_cell("granite-moe-1b-a400m", "train_4k", None, cfg_override=cfg,
                            shape_override=SMALL_TRAIN, fake=fake, device="cpu")
            for fake in (True, False)]
    fake, real = recs
    assert fake["ok"] and real["ok"], (fake.get("error"), real.get("error"))
    assert fake["mode"] == "fake" and real["mode"] == "real"
    assert fake["cost"]["flops_per_device"] == real["cost"]["flops_per_device"] > 0
    assert fake["cost"]["bytes_per_device"] == real["cost"]["bytes_per_device"] > 0
    assert fake["memory"] == real["memory"]
    assert fake["peak_bytes"] == real["peak_bytes"]
    assert fake["microbatches"] == 16 and fake["loss"] is None
    assert np.isfinite(real["loss"])


RANK_HEAD = """
import datetime, json, os
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], WORLD),
                        rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(seconds=120))


def report(**kw):
    with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
        json.dump(kw, f)
"""


def spawn(n: int, body: str, tmp_path: Path, timeout: int = 300):
    """Run ``body`` on ``n`` gloo ranks (a `FileStore` under ``tmp_path``);
    returns each rank's report."""
    code = RANK_HEAD + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, WORLD_SIZE=str(n), OUT=str(tmp_path),
               STORE=str(tmp_path / "store"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(f"rank {r} rc {p.returncode}:\n{err[-3000:]}")
    except subprocess.TimeoutExpired:
        errors.append(f"a rank passed the {timeout} s limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(n)]


def test_fake_collectives_equal_four_gloo_ranks(tmp_path):
    small = (SMALL_TRAIN.seq_len, SMALL_TRAIN.global_batch, SMALL_TRAIN.kind)
    fake = _fake_cells(4, (2, 2), ("data", "model"),
                       [("cell", "granite-moe-1b-a400m", "train_4k", small)])["cell"]
    reports = spawn(4, f"""
        from repro_torch.configs import get_arch, InputShape
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        rec = dryrun.run_cell("granite-moe-1b-a400m", "train_4k", mesh,
                              cfg_override=get_arch("granite-moe-1b-a400m").reduced(),
                              shape_override=InputShape("train_4k", *{small!r}),
                              fake=False, device="cpu")
        rec.pop("traceback", None)
        report(**rec)
    """, tmp_path)
    real = reports[0]
    assert fake["ok"] and real["ok"], (fake.get("error"), real.get("error"))
    assert fake["collectives"] == real["collectives"]
    assert set(fake["collectives"]) >= {"all-gather", "all-reduce"}
    assert fake["collective_bytes"] == real["collective_bytes"] > 0
    assert fake["cost"]["flops_per_device"] == real["cost"]["flops_per_device"]
    assert fake["cost"]["bytes_per_device"] == real["cost"]["bytes_per_device"]
    assert fake["memory"] == real["memory"]
    # Every rank moved the same bytes per kind (one program on every rank).
    assert all(r["collectives"] == real["collectives"] for r in reports)


def test_every_family_prefill_and_decode_trace_on_a_fake_mesh():
    cells = [("moe", "granite-moe-1b-a400m", "train_4k", (64, 32, "train")),
             ("ssm", "mamba2-2.7b", "train_4k", (64, 8, "train")),
             ("hybrid", "zamba2-1.2b", "train_4k", (64, 8, "train")),
             ("vlm", "llama-3.2-vision-90b", "train_4k", (32, 8, "train")),
             ("encdec", "whisper-large-v3", "train_4k", (32, 8, "train")),
             ("prefill", "qwen2-72b", "prefill_32k", (64, 8, "prefill")),
             ("decode", "qwen2-72b", "decode_32k", (128, 8, "decode")),
             ("skip", "qwen2-72b", "long_500k", None)]
    recs = _fake_cells(8, (2, 4), ("data", "model"), cells)
    for key, rec in recs.items():
        if key == "skip":
            assert not rec["ok"] and "sub-quadratic" in rec["skipped"]
            continue
        assert rec["ok"], (key, rec.get("error"))
        assert rec["cost"]["flops_per_device"] > 0, key
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0, key
        assert rec["collective_bytes"] > 0, key
    # A decode step writes the cache in place; prefill updates nothing.
    assert recs["decode"]["memory"]["alias_bytes"] > 0
    assert recs["prefill"]["memory"]["alias_bytes"] == 0
    assert recs["moe"]["microbatches"] == 16 and "microbatches" not in recs["decode"]
    # Batches of 8 over 2 data ranks: one microbatch (8 % 16), as the reference's.
    assert recs["ssm"]["microbatches"] == 1


# -- decode on a mesh ------------------------------------------------------------

@pytest.mark.parametrize("arch,layout", [
    ("qwen2-72b", ("seq",)),               # one kv head: the sequence is cut
    ("granite-moe-1b-a400m", ("heads",)),  # two kv heads: cut over model
    ("mamba2-2.7b", ("state",)),           # the SSD state's head dim is cut
    ("zamba2-1.2b", ("heads", "state")),   # Mamba states and the shared block's K/V
    ("whisper-large-v3", ("heads",))])     # self-attention K/V, live cross-attention
def test_decode_on_a_mesh_matches_one_process(arch, layout, tmp_path):
    reports = spawn(4, f"""
        import dataclasses
        from torch.distributed.tensor import DTensor, distribute_tensor
        from repro_torch.configs import get_arch
        from repro_torch.distributed.activations import cache_layout
        from repro_torch.distributed.sharding import cache_shardings, distribute_params, local_batch
        from repro_torch.launch.mesh import make_mesh, use_mesh
        from repro_torch.models import build_model

        cfg = dataclasses.replace(get_arch({arch!r}).reduced(), compute_dtype="float32")
        model = build_model(cfg)
        b, max_len, steps = 4, 32, 3
        gen = torch.Generator().manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (steps, b, 1), generator=gen)
        memory = torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=gen)
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")

        def filled(node, path=""):
            # Float32 caches, as after a prefill of 5 tokens.
            if isinstance(node, dict):
                return {{k: filled(v, f"{{path}}/{{k}}") for k, v in node.items()}}
            if node is None or not node.is_floating_point():
                return None if node is None else node.fill_(5)
            seed = sum(map(ord, path))
            return torch.randn(node.shape, generator=torch.Generator().manual_seed(seed))

        cuts = set()

        def sharded(node, sh, path=""):
            if isinstance(node, dict):
                return {{k: sharded(v, sh, f"{{path}}/{{k}}" if path else k)
                        for k, v in node.items()}}
            if node is None:
                return None
            t = distribute_tensor(node, mesh, sh[path].placements)
            if path.endswith("k") and cache_layout(t) is not None:
                cuts.add(cache_layout(t)[0])
            if path.endswith("state") and t.placements[1].is_shard():
                cuts.add("state")
            return t

        logits = {{}}
        for name in ("one", "mesh"):
            params = model.init(0, device="cpu")
            cache = filled(model.init_cache(b, max_len, device="cpu"))
            if name == "mesh":
                distribute_params(params, mesh, "tp")
                cache = sharded(cache, cache_shardings(cache, mesh))
            out = []
            with torch.no_grad(), use_mesh(mesh if name == "mesh" else None):
                for t in tokens:
                    batch = {{"token": t}}
                    if cfg.family == "encdec":
                        batch["memory"] = memory
                    if name == "mesh":
                        batch = local_batch(batch, mesh)
                    lg, cache = model.decode_step(params, batch, cache)
                    out.append(lg)
            logits[name] = out
        r_data = mesh.get_local_rank("data")
        r_model = mesh.get_local_rank("model")
        err, scale = 0.0, 0.0
        for one, loc in zip(logits["one"], logits["mesh"]):
            rows = one.chunk(2, 0)[r_data]
            want = rows.chunk(2, -1)[r_model] if loc.shape[-1] != rows.shape[-1] else rows
            err = max(err, float((loc - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
        report(err=err, scale=scale, cuts=sorted(cuts))
    """, tmp_path)
    for r in reports:
        assert r["cuts"] == list(layout), r
        assert r["err"] <= TOL * r["scale"], r


def _filled_reference_cache(node, fill, path=""):
    """The reference's decode cache with every floating array replaced by
    float32 normals (seeded by its path) and every integer one (the
    lengths) set to ``fill``: numpy arrays in the reference's layout."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _filled_reference_cache(v, fill, f"{path}/{k}") for k, v in node.items()}
    a = np.asarray(node)
    if np.issubdtype(a.dtype, np.integer):
        return np.full(a.shape, fill, a.dtype)
    rng = np.random.default_rng(sum(map(ord, path)))
    return rng.standard_normal(a.shape).astype(np.float32)


@pytest.mark.parametrize("arch,layout", [
    ("qwen2-72b", ("seq",)),
    ("granite-moe-1b-a400m", ("heads",)),
    ("mamba2-2.7b", ("state",)),
    ("zamba2-1.2b", ("heads", "state")),
    ("whisper-large-v3", ("heads",))])
def test_decode_on_a_mesh_matches_the_reference(arch, layout, tmp_path):
    import jax.numpy as jnp

    b, max_len, steps, filled = 4, 32, 3, 14
    rcfg = dataclasses.replace(rget(arch).reduced(), compute_dtype="float32")
    rm = rbuild(rcfg)
    rp = rm.init(jax.random.PRNGKey(3))
    cache = _filled_reference_cache(rm.init_cache(b, max_len), filled)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, rcfg.vocab_size, (steps, b, 1)).astype(np.int32)
    memory = (rng.standard_normal((b, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
              if rcfg.family == "encdec" else None)
    step = jax.jit(rm.decode_step)
    rc = jax.tree_util.tree_map(jnp.asarray, cache)
    want = []
    for t in tokens:
        batch = {"token": jnp.asarray(t)}
        if memory is not None:
            batch["memory"] = jnp.asarray(memory)
        lg, rc = step(rp, batch, rc)
        want.append(np.asarray(lg))
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump({"params": jax.tree_util.tree_map(np.asarray, rp), "cache": cache,
                     "tokens": tokens, "memory": memory, "logits": want}, f)
    reports = spawn(4, f"""
        import dataclasses, pickle
        import numpy as np
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_arch
        from repro_torch.convert import lm_params_from_reference
        from repro_torch.distributed.activations import cache_layout
        from repro_torch.distributed.sharding import cache_shardings, distribute_params, local_batch
        from repro_torch.launch.mesh import make_mesh, use_mesh
        from repro_torch.models import build_model
        from repro_torch.utils.tree import flatten_with_paths

        with open({str(tmp_path / "ref.pkl")!r}, "rb") as f:
            ref = pickle.load(f)
        cfg = dataclasses.replace(get_arch({arch!r}).reduced(), compute_dtype="float32")
        model = build_model(cfg)
        params = lm_params_from_reference(ref["params"], cfg, device="cpu")

        def tensors(node):
            if isinstance(node, dict):
                return {{k: tensors(v) for k, v in node.items()}}
            return None if node is None else torch.from_numpy(np.array(node))

        cache = tensors(ref["cache"])
        # The carried cache has the port's own layout, in float32.
        own = flatten_with_paths(model.init_cache({b}, {max_len}, device="cpu"))
        got = flatten_with_paths(cache)
        assert {{k: tuple(v.shape) for k, v in own.items() if v is not None}} == \
            {{k: tuple(v.shape) for k, v in got.items() if v is not None}}
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        distribute_params(params, mesh, "tp")
        shardings = cache_shardings(cache, mesh)
        cuts = set()

        def sharded(node, path=""):
            if isinstance(node, dict):
                return {{k: sharded(v, f"{{path}}/{{k}}" if path else k)
                        for k, v in node.items()}}
            if node is None:
                return None
            t = distribute_tensor(node, mesh, shardings[path].placements)
            if path.endswith("k") and cache_layout(t) is not None:
                cuts.add(cache_layout(t)[0])
            if path.endswith("state") and t.placements[1].is_shard():
                cuts.add("state")
            return t

        cache = sharded(cache)
        r_data, r_model = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        err, scale = 0.0, 0.0
        with torch.no_grad(), use_mesh(mesh):
            for tok, want in zip(ref["tokens"], ref["logits"]):
                batch = {{"token": torch.from_numpy(tok)}}
                if ref["memory"] is not None:
                    batch["memory"] = torch.from_numpy(ref["memory"])
                lg, cache = model.decode_step(params, local_batch(batch, mesh), cache)
                rows = torch.from_numpy(want).chunk(2, 0)[r_data]
                want = rows.chunk(2, -1)[r_model] if lg.shape[-1] != rows.shape[-1] else rows
                assert lg.shape == want.shape, (tuple(lg.shape), tuple(want.shape))
                err = max(err, float((lg - want).abs().max()))
                scale = max(scale, float(want.abs().max()))
        report(err=err, scale=scale, cuts=sorted(cuts))
    """, tmp_path)
    for r in reports:
        assert r["cuts"] == list(layout), r
        assert r["err"] <= TOL * r["scale"], r
