"""The port's multi-device layer against the reference's, on the host.

Each multi-rank test spawns gloo processes on the CPU with the rank
count and mesh of the reference test it mirrors
(``tests/test_distributed.py``): one process per rank, a rendezvous
through a `FileStore` under ``tmp_path`` (no TCP port, so xdist workers
cannot collide), one torch thread each, and a time limit per spawn, so a
hung rank fails the test instead of the suite.  The reference runs in
the test process on one jax device, or, where it needs a mesh, in a
subprocess with 8 forced host devices (the reference's own helper
pattern).  The ranks import only the port.

Tolerances, as each test states: the sharded train step within 1e-5
relative of the reference's jitted single-device step in float32 (and
of the port's own single-rank step), and within the reference test's
5e-2 at its default dtype; the FSDP gather within 1e-5 of TP; pipeline
within 1e-5 of sequential; ``compressed_psum`` bit-equal to the
reference's under shard_map; elastic recovery bit-equal; the sharded
tree flush bit-equal to the unsharded flush and within rtol 1e-4, atol
1e-7 of the numpy oracle.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget  # noqa: E402
from repro.distributed import sharding as rsharding  # noqa: E402
from repro.distributed.trainstep import init_train_state as rinit  # noqa: E402
from repro.distributed.trainstep import make_train_step as rstep  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.utils.tree import flatten_with_paths as rflatten  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.compression import stack_key  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
SPAWN_TIMEOUT = 240
TOL = 1e-5
FAMILIES = ["granite-moe-1b-a400m", "qwen2-72b", "mamba2-2.7b", "zamba2-1.2b",
            "gemma2-27b", "llama-3.2-vision-90b", "whisper-large-v3"]

RANK_HEAD = """
import datetime, json, os, sys
import numpy as np
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


def spawn(n: int, body: str, tmp_path: Path, timeout: int = SPAWN_TIMEOUT):
    """Run ``body`` on ``n`` gloo ranks; returns each rank's report."""
    code = RANK_HEAD + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
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
    reports = []
    for r in range(n):
        path = tmp_path / f"rank{r}.json"
        reports.append(json.loads(path.read_text()) if path.exists() else None)
    return reports


def run_reference_subprocess(body: str, timeout: int = 420) -> str:
    """The reference's helper: jax with 8 forced host devices."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax
        import jax.numpy as jnp
        import numpy as np
    """) + textwrap.dedent(body)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-3000:]}"
    return proc.stdout


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _save_reference_state(cfg, path: Path, seed: int = 0):
    state = rinit(rbuild(cfg), jax.random.PRNGKey(seed))
    np.savez(path, **{k: np.asarray(v) for k, v in rflatten(state).items()})
    return state


def _synthetic_batch(cfg, batch: int, seq: int):
    from repro.data.pipeline import SyntheticLMData

    return SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=0).batch_at(0)


# -- the sharded train step ---------------------------------------------------------

def test_sharded_train_step_matches_single_device(tmp_path):
    """Reduced qwen2-72b (4 query heads over 1 kv head) on a (2, 4)
    data×model mesh, one step, against the reference's jitted step on one
    device and the port's single-rank step: loss and grad norm within
    1e-5 relative in float32, and the reference test's own gate (5e-2 on
    the loss, ones for tokens and labels) at the default dtype.  Every
    flash call on the mesh saw one local query head; a DTensor handed to
    the kernel dispatch raises."""
    out = {}
    for name, cfg, batch in (
            ("f32", dataclasses.replace(rget("qwen2-72b").reduced(), compute_dtype="float32"),
             _synthetic_batch(rget("qwen2-72b").reduced(), 8, 32)),
            ("default", rget("qwen2-72b").reduced(),
             {"tokens": np.ones((8, 32), np.int32), "labels": np.ones((8, 32), np.int32)})):
        state = _save_reference_state(cfg, tmp_path / f"{name}.npz")
        _, m = jax.jit(rstep(rbuild(cfg)))(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out[name] = (float(m["loss"]), float(m["grad_norm"]))
        np.savez(tmp_path / f"{name}_batch.npz", **batch)
    reports = spawn(8, f"""
        import dataclasses
        from repro_torch.configs import get_arch
        from repro_torch.convert import train_state_from_reference
        from repro_torch.distributed.trainstep import make_train_step
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model

        heads = []
        plain = fa.flash_attention_plain
        fa.flash_attention_plain = lambda q, *a, **k: heads.append(q.shape[2]) or plain(q, *a, **k)
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        res = {{}}
        for name, cfg in (("f32", dataclasses.replace(get_arch("qwen2-72b").reduced(),
                                                      compute_dtype="float32")),
                          ("default", get_arch("qwen2-72b").reduced())):
            flat = dict(np.load(os.path.join({str(tmp_path)!r}, name + ".npz")))
            batch = {{k: torch.from_numpy(v) for k, v in
                     np.load(os.path.join({str(tmp_path)!r}, name + "_batch.npz")).items()}}
            model = build_model(cfg)
            _, m = make_train_step(model, mesh=mesh)(
                train_state_from_reference(flat, cfg, device="cpu"), batch)
            res[name] = [float(m["loss"]), float(m["grad_norm"])]
            if name == "f32":
                mesh_heads, heads[:] = sorted(set(heads)), []
                _, m1 = make_train_step(model)(
                    train_state_from_reference(flat, cfg, device="cpu"), batch)
                res["single"] = [float(m1["loss"]), float(m1["grad_norm"])]
        from torch.distributed.tensor import distribute_tensor, Replicate
        q = distribute_tensor(torch.zeros(1, 4, 4, 8), mesh, [Replicate(), Replicate()])
        try:
            ops.flash_attention(q, q, q)
            refused = False
        except TypeError:
            refused = True
        report(res=res, heads=mesh_heads, refused=refused)
    """, tmp_path)
    for rep in reports:
        assert rep["heads"] == [1] and rep["refused"], rep
        loss, gnorm = rep["res"]["f32"]
        assert _rel(loss, out["f32"][0]) < TOL and _rel(gnorm, out["f32"][1]) < TOL, (rep, out)
        assert _rel(loss, rep["res"]["single"][0]) < TOL
        assert _rel(gnorm, rep["res"]["single"][1]) < TOL
        assert abs(rep["res"]["default"][0] - out["default"][0]) < 5e-2, (rep, out)


def test_fsdp_gather_numerics_match_tp(tmp_path):
    """fsdp_gather=seq_shard=True (fsdp variant: rows over data, the
    layer carry cut over model along the sequence) against both false (tp
    variant) on a (2, 4) mesh, reduced qwen2-72b in float32: one train
    step's loss and grad norm within 1e-5 of each other and the loss
    within 1e-5 of the reference's single-device ``model.loss``."""
    cfg = dataclasses.replace(rget("qwen2-72b").reduced(), compute_dtype="float32")
    state = _save_reference_state(cfg, tmp_path / "state.npz")
    batch = _synthetic_batch(cfg, 4, 32)
    np.savez(tmp_path / "batch.npz", **batch)
    want, _ = jax.jit(rbuild(cfg).loss)(state.params, {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    reports = spawn(8, f"""
        import dataclasses
        from repro_torch.configs import get_arch
        from repro_torch.convert import train_state_from_reference
        from repro_torch.distributed.trainstep import make_train_step
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model

        base = dataclasses.replace(get_arch("qwen2-72b").reduced(), compute_dtype="float32")
        flat = dict(np.load(os.path.join({str(tmp_path)!r}, "state.npz")))
        batch = {{k: torch.from_numpy(v) for k, v in
                 np.load(os.path.join({str(tmp_path)!r}, "batch.npz")).items()}}
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        res = {{}}
        for fsdp in (False, True):
            cfg = dataclasses.replace(base, fsdp_gather=fsdp, seq_shard=fsdp)
            step = make_train_step(build_model(cfg), mesh=mesh,
                                   variant="fsdp" if fsdp else "tp")
            _, m = step(train_state_from_reference(flat, cfg, device="cpu"), batch)
            res[str(fsdp)] = [float(m["loss"]), float(m["grad_norm"])]
        report(res=res)
    """, tmp_path)
    for rep in reports:
        tp, fsdp = rep["res"]["False"], rep["res"]["True"]
        assert _rel(fsdp[0], tp[0]) < TOL and _rel(fsdp[1], tp[1]) < TOL, rep
        assert _rel(tp[0], want) < TOL, (rep, float(want))


def test_one_rank_sharded_gap_is_the_gathers_cast(tmp_path):
    """Reduced Granite-MoE, 2 steps of 2 × 64 tokens on one gloo rank,
    (1, 1) mesh: the sharded step (fsdp variant, fsdp_gather and
    seq_shard) against the unsharded one, bit for bit in float32; in
    bfloat16 seq_shard alone stays bit-equal, and the sharded losses are
    those of the unsharded step with fsdp_gather alone and no mesh, whose
    one effect is the reference's cast of every floating leaf (norm scales
    and router too) to the compute dtype (``src/repro/distributed/fsdp.py``
    ``gather_layer``).  On the card that cast is the sharded Granite
    step's bfloat16 loss gap at step 1 (``probe_train_repeat.py
    sharded``), and float32 is bit-equal there too."""
    reports = spawn(1, """
        import dataclasses
        from repro_torch.configs import get_arch
        from repro_torch.distributed import init_train_state, make_train_step
        from repro_torch.data import SyntheticLMData
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model

        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        runs = {"unsharded": ({}, False),
                "sharded": ({"fsdp_gather": True, "seq_shard": True}, True),
                "seq_shard": ({"seq_shard": True}, True),
                "cast": ({"fsdp_gather": True}, False)}
        res = {}
        for dtype in ("float32", "bfloat16"):
            base = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                                       compute_dtype=dtype)
            data = SyntheticLMData(vocab_size=base.vocab_size, seq_len=64,
                                   global_batch=2, seed=0)
            for name, (fields, on_mesh) in runs.items():
                model = build_model(dataclasses.replace(base, **fields))
                state = init_train_state(model, 0, device="cpu")
                kw = dict(mesh=mesh, variant="fsdp") if on_mesh else {}
                step = make_train_step(model, **kw, base_lr=3e-4, warmup_steps=1,
                                       total_steps=2)
                losses = []
                for i in range(2):
                    batch = {k: torch.as_tensor(v) for k, v in data.batch_at(i).items()}
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                res[f"{dtype} {name}"] = losses
        report(res=res)
    """, tmp_path)
    res = reports[0]["res"]
    for name in ("sharded", "seq_shard", "cast"):
        assert res[f"float32 {name}"] == res["float32 unsharded"], res
    assert res["bfloat16 seq_shard"] == res["bfloat16 unsharded"], res
    assert res["bfloat16 sharded"] == res["bfloat16 cast"] != res["bfloat16 unsharded"], res


# Per family: (variant, fsdp_gather and seq_shard) of the sweep below.
SWEEP = {"granite-moe-1b-a400m": ("tp", False), "mamba2-2.7b": ("fsdp", True),
         "zamba2-1.2b": ("tp", True), "gemma2-27b": ("fsdp", False),
         "llama-3.2-vision-90b": ("fsdp", True), "whisper-large-v3": ("tp", False)}


@pytest.mark.parametrize("arch", sorted(SWEEP))
def test_every_family_trains_sharded_as_on_one_rank(arch, tmp_path):
    """Each family's reduced config in float32 on a (2, 2) mesh, 3 steps
    of 4 × 64 tokens (lr 1e-2 after one warm-up step): loss and grad norm
    within 1e-5 relative of the port's step on one rank, every step.  The
    kernels ran on local shards: flash on h/2 query heads, the GMM on e/2
    experts and the SSD scan on h/2 heads, where those divide."""
    variant, flags = SWEEP[arch]
    reports = spawn(4, f"""
        import dataclasses
        from repro_torch.configs import get_arch
        from repro_torch.data import SyntheticLMData
        from repro_torch.distributed import init_train_state, make_train_step
        from repro_torch.kernels import flash_attention as fa, moe_gmm as gmm, ssd_scan as ss
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model

        seen = {{"flash": set(), "gmm": set(), "scan": set()}}
        for mod, name, key, dim in ((fa, "flash_attention_plain", "flash", 2),
                                    (gmm, "moe_gmm_plain", "gmm", 0),
                                    (ss, "ssd_scan_plain", "scan", 2)):
            real = getattr(mod, name)
            setattr(mod, name, lambda x, *a, _r=real, _k=key, _d=dim, **k:
                    seen[_k].add(x.shape[_d]) or _r(x, *a, **k))
        base = dataclasses.replace(get_arch({arch!r}).reduced(), compute_dtype="float32")
        cfg = dataclasses.replace(base, fsdp_gather={flags}, seq_shard={flags})
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=0,
                               with_vision=cfg.vision_seq if cfg.family == "vlm" else 0,
                               with_frames=cfg.encoder_seq if cfg.family == "encdec" else 0,
                               d_model=cfg.d_model)
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        res = {{}}
        for name, c, m in (("one_rank", base, None), ("sharded", cfg, mesh)):
            model = build_model(c)
            state = init_train_state(model, 0, device="cpu")
            if "cross_layers" in state.params:
                with torch.no_grad():
                    for cp in state.params["cross_layers"]:
                        cp["gate"].fill_(0.7)
            step = make_train_step(model, mesh=m, variant={variant!r}, base_lr=1e-2,
                                   warmup_steps=1)
            out = []
            for i in range(3):
                batch = {{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}}
                state, metrics = step(state, batch)
                out.append([float(metrics["loss"]), float(metrics["grad_norm"])])
            res[name] = out
            if name == "one_rank":
                whole = {{k: sorted(v) for k, v in seen.items()}}
                for v in seen.values():
                    v.clear()
        report(res=res, whole=whole, local={{k: sorted(v) for k, v in seen.items()}})
    """, tmp_path)
    cfg = get_arch(arch).reduced()
    for rep in reports:
        for got, want in zip(rep["res"]["sharded"], rep["res"]["one_rank"]):
            assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL, rep["res"]
        assert rep["res"]["one_rank"][0] != rep["res"]["one_rank"][2]
        for key, whole in rep["whole"].items():
            want = [w // 2 if w % 2 == 0 else w for w in whole]
            assert rep["local"][key] == want, (key, rep["whole"], rep["local"])
    if cfg.num_experts:
        assert reports[0]["local"]["gmm"] == [cfg.num_experts // 2]


@pytest.mark.parametrize("arch", ["qwen2-72b", "granite-moe-1b-a400m", "whisper-large-v3"])
def test_dense_products_split_over_the_model_axis(arch, tmp_path):
    """Tensor parallelism: on a (1, 2) data×model mesh each rank's forward
    and loss (reduced config, float32, 4 × 32 tokens) counts at most 0.55
    of the one-rank matmul FLOPs (`torch.utils.flop_counter`: the q, k, v,
    o, MLP and head products column- and row-cut, attention and the GMM
    on local heads and experts), the layers see column-cut q and row-cut o
    kernels, and the loss is the one-rank loss within 1e-5."""
    reports = spawn(2, f"""
        import dataclasses
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs import get_arch
        from repro_torch.data import SyntheticLMData
        from repro_torch.distributed.fsdp import gather_layer
        from repro_torch.distributed.sharding import distribute_params
        from repro_torch.launch.mesh import make_mesh, use_mesh
        from repro_torch.models import build_model

        cfg = dataclasses.replace(get_arch({arch!r}).reduced(), compute_dtype="float32")
        model = build_model(cfg)
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0,
                               with_frames=cfg.encoder_seq if cfg.family == "encdec" else 0,
                               d_model=cfg.d_model)
        batch = {{k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}}
        mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
        res = {{}}
        for name, m in (("one_rank", None), ("sharded", mesh)):
            params = model.init(0, device="cpu")
            if m is not None:
                distribute_params(params, m, "tp")
            with torch.no_grad(), use_mesh(m), FlopCounterMode(display=False) as fc:
                loss, _ = model.loss(params, batch)
            res[name] = [float(loss), fc.get_total_flops()]
            if m is not None:
                stack = "dec_layers" if cfg.family == "encdec" else "layers"
                with use_mesh(m):
                    attn = gather_layer(params[stack][0], cfg)["attn"]
                res["cuts"] = [attn["q"].cut("kernel"), attn["o"].cut("kernel"),
                               list(attn["q"]["kernel"].shape)]
        report(res=res)
    """, tmp_path)
    cfg = get_arch(arch).reduced()
    for rep in reports:
        one, sharded = rep["res"]["one_rank"], rep["res"]["sharded"]
        assert _rel(sharded[0], one[0]) < TOL, rep
        assert sharded[1] <= 0.55 * one[1], rep
        assert rep["res"]["cuts"] == [1, 0, [cfg.d_model, cfg.num_heads * cfg.head_dim // 2]]


# -- pipeline, compressed psum -----------------------------------------------------------

def test_pipeline_parallel_matches_sequential(tmp_path):
    """4 pipe ranks, L=8, d=16, M=4, mb=2, s=4, tanh(x @ w): every rank's
    output within 1e-5 of the sequential reference; the bubble fraction is
    the reference's."""
    from repro.distributed.pipeline import pipeline_bubble_fraction as rbubble

    from repro_torch.distributed.pipeline import pipeline_bubble_fraction

    rng = np.random.default_rng(0)
    L, d, M, mb, s = 8, 16, 4, 2, 4
    ws = np.asarray(rng.standard_normal((L, d, d)) * 0.1, np.float32)
    x = np.asarray(rng.standard_normal((M, mb, s, d)), np.float32)
    ref = jnp.asarray(x)
    for i in range(L):
        ref = jnp.tanh(ref @ jnp.asarray(ws[i]))
    np.savez(tmp_path / "in.npz", ws=ws, x=x)
    reports = spawn(4, f"""
        from repro_torch.distributed.pipeline import pipeline_forward, split_layers_to_stages
        from repro_torch.launch.mesh import make_mesh
        data = np.load(os.path.join({str(tmp_path)!r}, "in.npz"))
        ws, x = torch.from_numpy(data["ws"]), torch.from_numpy(data["x"])
        mesh = make_mesh((4,), ("pipe",), device_type="cpu")
        out = pipeline_forward(lambda w, a: torch.tanh(a @ w), split_layers_to_stages(ws, 4),
                               x, mesh=mesh, axis="pipe")
        report(out=out.numpy().tolist())
    """, tmp_path)
    for rep in reports:
        err = float(np.abs(np.asarray(rep["out"], np.float32) - np.asarray(ref)).max())
        assert err < TOL, err
    for S, M_ in ((4, 4), (2, 8), (1, 3)):
        assert pipeline_bubble_fraction(S, M_) == rbubble(S, M_)


def test_compressed_psum_bit_equal_to_the_reference(tmp_path):
    """8 ranks over a (8,) data axis, each with its row of the reference
    test's seeded (8, 64) input: relative error below 0.02 against the
    true sum, and every rank's result bit-equal to the reference's
    ``compressed_psum`` under shard_map."""
    run_reference_subprocess(f"""
        from jax.sharding import PartitionSpec as P
        from repro.distributed.compression import compressed_psum
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((8,), ("data",))
        x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 64)), jnp.float32)
        f = jax.shard_map(lambda xl: compressed_psum(xl[0], "data"), mesh=mesh,
                          in_specs=P("data"), out_specs=P())
        np.save({str(tmp_path / "ref.npy")!r}, np.asarray(f(x)))
    """)
    reports = spawn(8, """
        from repro_torch.distributed.compression import compressed_psum
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((8,), ("data",), device_type="cpu")
        x = torch.from_numpy(np.asarray(np.random.default_rng(0).standard_normal((8, 64)),
                                        np.float32))
        got = compressed_psum(x[RANK], "data", mesh)
        report(got=got.numpy().view(np.int32).tolist())
    """, tmp_path)
    x = np.asarray(np.random.default_rng(0).standard_normal((8, 64)), np.float32)
    want = np.load(tmp_path / "ref.npy")
    for rep in reports:
        got = np.asarray(rep["got"], np.int32).view(np.float32)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        rel = np.linalg.norm(got - x.sum(0)) / np.linalg.norm(x.sum(0))
        assert rel < 0.02, rel


# -- elastic ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mp,pods", [(256, 16, 1), (192, 16, 1), (24, 16, 1),
                                       (512, 16, 2), (8, 4, 1), (1, 16, 1), (6, 4, 1)])
def test_elastic_mesh_shapes_are_the_references(n, mp, pods):
    from repro.launch.mesh import elastic_mesh_shape as rshape

    from repro_torch.launch.mesh import elastic_mesh_shape

    assert elastic_mesh_shape(n, model_parallel=mp, pods=pods) == \
        rshape(n, model_parallel=mp, pods=pods)


def test_elastic_recovery_roundtrip(tmp_path):
    """Reduced Granite-MoE's train state sharded on an (8,) data mesh (fsdp
    rules), saved at step 42, recovered onto a (2, 4) mesh: resumed at 42,
    every leaf laid out by the (2, 4) rules and bit-equal to the saved
    state."""
    reports = spawn(8, f"""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import get_arch
        from repro_torch.distributed.elastic import recover
        from repro_torch.distributed.sharding import shard_params
        from repro_torch.distributed.trainstep import init_train_state, shard_train_state
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model
        from repro_torch.utils.tree import flatten_with_paths

        model = build_model(get_arch("granite-moe-1b-a400m").reduced())
        whole = {{k: v.detach().clone() for k, v in
                 flatten_with_paths(init_train_state(model, 0, device="cpu")).items()}}
        state = shard_train_state(init_train_state(model, 0, device="cpu"),
                                  make_mesh((8,), ("data",), device_type="cpu"), "fsdp")
        ckpt = CheckpointManager({str(tmp_path / "ckpt")!r}, async_save=False)
        ckpt.save(42, state, {{"mesh_shape": [8]}})
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        target = init_train_state(model, 1, device="cpu")
        restored, plan = recover(ckpt, target, mesh=mesh)
        specs = shard_params(target, mesh)
        same, laid = True, True
        for k, v in flatten_with_paths(restored).items():
            if v.dim():
                laid &= tuple(v.placements) == specs[k].placements
                v = v.full_tensor()
            same &= bool(torch.equal(v.detach(), whole[k]))
        sharded = sum(any(p.is_shard() for p in v.placements)
                      for v in flatten_with_paths(restored.params).values())
        report(step=plan.step, resumed=plan.resumed, same=same, laid=laid, sharded=sharded)
    """, tmp_path)
    for rep in reports:
        assert rep == {"step": 42, "resumed": True, "same": True, "laid": True,
                       "sharded": rep["sharded"]} and rep["sharded"] > 0, rep


# -- the sharded tree flush ---------------------------------------------------------------

def test_sharded_tree_flush_matches_numpy_and_is_deterministic():
    """The reference test's GBDT and 2,050 rows (above SHARD_MIN_ROWS, not
    a multiple of 8) over ``devices=["cpu"] * 8``: within rtol 1e-4, atol
    1e-7 of the reference's float64 numpy oracle, bit-equal to the port's
    unsharded flush and to a second sharded flush, one upload; the fused
    route passes the reference test's gate; 64 rows stay unsharded.  (The
    reference's own jax tier fails this on the installed jax.)"""
    from repro.core.predictors import GBDTPredictor as RGBDT

    from repro_torch.core.predictors import load_predictor
    from repro_torch.kernels import tree_gather as tg

    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal((200, 8))) * np.linspace(1, 30, 8)
    y = x @ rng.random(8) + 0.1
    rm = RGBDT(n_stages=20).fit(x, y)
    q = np.abs(rng.standard_normal((2050, 8))) * np.linspace(1, 30, 8)
    ref = rm.flat().predict_trees(rm.scaler.transform(q), backend="numpy")

    m = load_predictor(rm.to_json(), device="cpu")
    flat = m.flat()
    xs = m.scaler.transform(q)
    assert np.array_equal(flat.predict_trees(xs, backend="numpy"), ref)
    unsharded = flat.predict_trees(xs, backend="torch")
    db = flat.device_bank("cpu", devices=["cpu"] * 8)
    assert db.stats()["sharded"] and len(db.devices) == 8
    staged = db.stage_input(xs)
    assert isinstance(staged, tg.ShardedRows) and [len(s) for s in staged.shards] == [257] * 8
    got = flat.predict_trees(xs, backend="torch")
    assert got.shape == ref.shape
    assert np.allclose(got, ref, rtol=1e-4, atol=1e-7)
    assert np.array_equal(got, unsharded)
    assert np.array_equal(got, flat.predict_trees(xs, backend="torch"))
    assert db.uploads == 1 and flat.device_bank("cpu") is db
    dev = m.predict_on_device(np.asarray(q, np.float32), device="cpu")
    assert np.allclose(dev, rm.predict(q), rtol=1e-3, atol=1e-5)
    assert isinstance(db.stage_input(xs[:64]), torch.Tensor)
    assert np.allclose(flat.predict_trees(xs[:64], backend="torch"), ref[:64],
                       rtol=1e-4, atol=1e-7)


def test_sharded_flush_counts_one_launch_per_shard(monkeypatch):
    """Each shard of a sharded flush is one call of the traversal (one
    kernel launch on the card); a flush below SHARD_MIN_ROWS is one."""
    from repro_torch.core.predictors import GBDTPredictor
    from repro_torch.kernels import tree_gather as tg

    calls = []
    for name in ("gather_leaves_plain", "fused_plain"):
        real = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(1)
    x = rng.random((100, 4))
    m = GBDTPredictor(n_stages=5, max_depth=3).fit(x, x.sum(1))
    m.flat().device_bank("cpu", devices=["cpu"] * 4)
    big = rng.random((tg.SHARD_MIN_ROWS + 3, 4))
    m.flat().predict_trees(big, backend="torch")
    m.predict_on_device(big.astype(np.float32), device="cpu")
    m.predict_on_device(big[:10].astype(np.float32), device="cpu")
    # (the fused plain version walks the trees with gather_leaves_plain)
    assert calls == ["gather_leaves_plain"] * 4 + ["fused_plain", "gather_leaves_plain"] * 5


# -- spec parity ---------------------------------------------------------------------

def _port_leaves(arch: str, reduced: bool):
    """(port path, reference path, lead, reference shape) of every leaf of
    the reference's stacked tree, unstacked into the port's paths."""
    cfg = rget(arch).reduced() if reduced else rget(arch)
    shapes = rflatten(jax.eval_shape(rbuild(cfg).init, jax.random.PRNGKey(0)))
    out = []
    for path, leaf in shapes.items():
        shape = tuple(leaf.shape)
        lead = rsharding._stacked_lead(path, len(shape), rsharding._base_ndim(path))
        stack, _, rest = path.partition("/")
        for idx in range(int(np.prod(shape[:lead])) if lead else 1):
            port = f"{stack}/{idx}/{rest}" if lead else path
            out.append((port, path, lead, shape))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_pspec_matches_the_reference_on_unstacked_leaves(arch):
    """For every leaf of each family's reduced config, in both variants,
    the port's ``param_pspec`` equals the reference's on the stacked leaf
    with the lead axes dropped; the port's own tree has exactly these
    leaves."""
    from repro_torch.distributed.sharding import param_pspec

    leaves = _port_leaves(arch, reduced=True)
    port_tree = flatten_with_paths(build_model(get_arch(arch).reduced()).init(0, device="cpu"))
    assert {p: tuple(t.shape) for p, t in port_tree.items()} == \
        {p: s[lead:] for p, _, lead, s in leaves}
    for variant in ("tp", "fsdp"):
        for port, ref, lead, shape in leaves:
            want = tuple(rsharding.param_pspec(ref, jax.ShapeDtypeStruct(shape, jnp.float32),
                                               variant))[lead:]
            got = param_pspec(port, _Shape(shape[lead:]), variant)
            assert tuple(got) == want, (variant, port)
            assert stack_key(port) == ref


class _StubMesh:
    """The axis names and shape `shard_params` reads from a mesh."""

    def __init__(self, shape, names):
        self.mesh = np.zeros(shape)
        self.mesh_dim_names = names


@pytest.fixture(scope="module")
def reference_layouts(tmp_path_factory):
    """The reference's ``shard_params`` (both variants) and
    ``cache_shardings`` on a (2, 4) mesh, every family at reduced and full
    size, from a subprocess with 8 host devices."""
    out = tmp_path_factory.mktemp("layouts") / "layouts.json"
    run_reference_subprocess(f"""
        import json
        from repro.configs import get_arch
        from repro.models import build_model
        from repro.distributed.sharding import shard_params, cache_shardings, _path_str
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((2, 4), ("data", "model"))
        def spec(s):
            return [list(p) if isinstance(p, tuple) else p for p in s.spec]
        res = {{}}
        for arch in {FAMILIES!r}:
            for size in ("reduced", "full"):
                cfg = get_arch(arch).reduced() if size == "reduced" else get_arch(arch)
                model = build_model(cfg)
                shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
                row = {{}}
                for variant in ("tp", "fsdp"):
                    sh = shard_params(shapes, mesh, variant)
                    row[variant] = {{_path_str(k): spec(v) for k, v in
                                    jax.tree_util.tree_flatten_with_path(sh)[0]}}
                cache = jax.eval_shape(lambda: model.init_cache(8, 64))
                sh = cache_shardings(cache, mesh)
                row["cache"] = {{_path_str(k): spec(v) for k, v in
                                jax.tree_util.tree_flatten_with_path(sh)[0]}}
                res[arch + "/" + size] = row
        json.dump(res, open({str(out)!r}, "w"))
    """)
    return json.loads(out.read_text())


def _spec_list(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_params_divisibility_and_cache_layout_match(reference_layouts, arch, size):
    """The divisibility rule on a (2, 4) mesh, both variants, at reduced
    and full width (full Granite's vocabulary, 49,155, stays unsharded),
    and ``cache_shardings`` of the reduced decode caches (batch 8, 64
    positions): the port's specs are the reference's with the lead axes
    dropped (caches keep theirs)."""
    want = reference_layouts[f"{arch}/{size}"]
    mesh = _StubMesh((2, 4), ("data", "model"))
    leaves = _port_leaves(arch, reduced=size == "reduced")
    shaped = {port: _Shape(shape[lead:]) for port, _, lead, shape in leaves}
    for variant in ("tp", "fsdp"):
        got = sharding.shard_params(shaped, mesh, variant)
        for port, ref, lead, _ in leaves:
            assert _spec_list(got[port].spec) == want[variant][ref][lead:], (variant, port)
    if arch == "granite-moe-1b-a400m" and size == "full":
        assert got["embed/embedding"].spec[0] is None
    if size == "reduced":
        cache = build_model(get_arch(arch).reduced()).init_cache(8, 64, device="cpu")
        got = sharding.cache_shardings(cache, mesh)
        assert {k: _spec_list(v.spec) for k, v in got.items()} == want["cache"]


class _Shape:
    """A leaf stand-in with only a shape (full-width trees stay unbuilt)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


# -- the training driver on gloo ranks ---------------------------------------------------

def test_launch_train_on_four_gloo_ranks_matches_one_rank(tmp_path):
    """``launch/train.py`` inside a 4-rank gloo group (``--model-parallel
    2``: a (2, 2) mesh) for 3 steps, reduced qwen2-72b at float32 compute:
    every rank's losses within 1e-5 of the driver on one process."""
    from repro_torch.launch import train

    argv = ["--arch", "qwen2-72b-reduced", "--steps", "3", "--global-batch", "4",
            "--seq-len", "32", "--lr", "1e-2", "--log-every", "1", "--device", "cpu"]
    real = train.get_arch
    train.get_arch = lambda name: dataclasses.replace(real(name), compute_dtype="float32")
    try:
        single = train.main(argv)
    finally:
        train.get_arch = real
    reports = spawn(4, f"""
        import dataclasses
        from repro_torch.launch import train
        real = train.get_arch
        train.get_arch = lambda name: dataclasses.replace(real(name), compute_dtype="float32")
        report(losses=train.main({argv + ["--model-parallel", "2"]!r}))
    """, tmp_path)
    assert single[0] != single[-1]
    for rep in reports:
        assert len(rep["losses"]) == 3
        for a, b in zip(rep["losses"], single):
            assert _rel(a, b) < TOL, (rep["losses"], single)


# -- off-mesh the hooks are the identity ----------------------------------------------

def test_hooks_are_the_identity_off_mesh():
    """Without a mesh: `gather_layer` and `pin_layer_stack` hand back
    their input unless ``fsdp_gather`` is set, `local_params` always, and
    the activation helpers return their tensor."""
    from repro_torch.distributed import activations as act
    from repro_torch.distributed.fsdp import gather_layer, local_params, pin_layer_stack
    from repro_torch.distributed.sharding import PartitionSpec as P

    cfg = get_arch("qwen2-72b").reduced()
    params = build_model(cfg).init(0, device="cpu")
    lp = params["layers"][0]
    assert gather_layer(lp, cfg) is lp and local_params(params) is params
    assert pin_layer_stack(params["layers"], cfg) is params["layers"]
    x = torch.randn(2, 8, 16)
    for fn in (lambda t: act.constrain(t, P(None, "model", None)),
               lambda t: act.constrain_seq(t, dataclasses.replace(cfg, seq_shard=True)),
               act.constrain_logits, lambda t: act.model_shard(t, 1),
               lambda t: act.model_whole(t, 1), act.batch_mean, act.model_copy,
               lambda t: act.heads_local(t, 1, 8)):
        assert fn(x) is x
    assert act.attention_heads(x[..., None], x[..., None], x[..., None]) is None
    cast = gather_layer(lp, dataclasses.replace(cfg, fsdp_gather=True))
    assert cast["attn"]["q"]["kernel"].dtype == torch.bfloat16
    assert torch.equal(cast["attn"]["q"]["kernel"], lp["attn"]["q"]["kernel"].bfloat16())
