"""The port's training infrastructure (checkpoint manager, data pipeline,
gradient compression, AdamW, schedules, tree helpers) against the
reference's, on the host.

The scripts of tests/test_infra.py's ``TestCheckpoint``,
``TestDataPipeline``, ``TestCompression`` and ``TestSchedules`` run on
both packages (``pkg`` parametrizes them); then the two packages are held
against each other on the same inputs, made from a numpy seed:
  * data batches: bit-equal (the port's pipeline is a numpy copy);
  * schedules at steps 0…300 in float32: the warm-up steps bit-equal; the
    cosine part within four float32 ulps of the rate, because XLA's and
    torch's float32 ``cos`` differ in the last bit for some arguments
    (measured: 979 of 20,001 points on [0, π]; neither is correctly
    rounded), and that ulp passes through 0.5·(1 + cos), the blend with
    ``min_ratio`` and the base rate, each rounding once (measured: at
    most 3 ulps);
  * `compress_grads`, `global_norm` and `adamw_update` on random trees:
    within 1e-6 of the largest value.  The reference sums leaves in its
    sorted-key order and XLA may fuse, so a float32 sum can differ by an
    ulp.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RCheckpointManager  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RData  # noqa: E402
from repro.distributed import compression as rcomp  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import schedules as rsched  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import schedules as sched  # noqa: E402
from repro_torch.utils import tree as ptree  # noqa: E402

TOL = 1e-6                              # × the largest value compared
PKGS = ["repro", "repro_torch"]


def _arr(pkg, a):
    return jnp.asarray(a) if pkg == "repro" else torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.detach().numpy()


# -- the reference's infra scripts on both packages ---------------------------------

def _manager(pkg):
    return RCheckpointManager if pkg == "repro" else CheckpointManager


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_save_restore_roundtrip(tmp_path, pkg):
    ckpt = _manager(pkg)(str(tmp_path), async_save=False)
    tree = {"a": np.arange(10, dtype=np.float32),
            "b": {"c": np.ones((3, 4), np.float32)}}
    ckpt.save(5, tree, {"note": "x"})
    restored, meta = ckpt.restore(target=tree)
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])
    assert meta["step"] == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_latest_and_gc(tmp_path, pkg):
    ckpt = _manager(pkg)(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"a": np.zeros(3, np.float32)})
    assert ckpt.latest_step() == 4
    assert ckpt.all_steps() == [3, 4]


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_tmp_dirs_ignored(tmp_path, pkg):
    ckpt = _manager(pkg)(str(tmp_path), async_save=False)
    ckpt.save(1, {"a": np.zeros(3, np.float32)})
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ckpt.latest_step() == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_async_save(tmp_path, pkg):
    ckpt = _manager(pkg)(str(tmp_path), async_save=True)
    ckpt.save(7, {"a": np.arange(5, dtype=np.float32)})
    ckpt.wait()
    assert ckpt.latest_step() == 7
    ckpt.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_restore_with_namedtuple_state(tmp_path, pkg):
    init = radamw.adamw_init if pkg == "repro" else adamw.adamw_init
    params = {"w": _arr(pkg, np.ones((4, 4), np.float32))}
    opt = init(params)
    ckpt = _manager(pkg)(str(tmp_path), async_save=False)
    ckpt.save(1, {"params": params, "opt": opt})
    restored, _ = ckpt.restore(target={"params": params, "opt": opt})
    mu = restored["opt"].mu["w"] if pkg == "repro" else restored["opt"].mu["w"]
    np.testing.assert_array_equal(_np(mu), _np(opt.mu["w"]))
    assert type(restored["opt"]) is type(opt)


def test_port_checkpoint_layout_is_the_references(tmp_path):
    """Both packages write step_<n>/arrays.npz + manifest.json under the
    same keys, and each reads the other's."""
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "step": np.int32(3)}
    RCheckpointManager(str(tmp_path / "r"), async_save=False).save(3, tree)
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(
        3, {"params": {"w": torch.from_numpy(tree["params"]["w"])},
            "step": torch.tensor(3, dtype=torch.int32)})
    for d in ("r", "p"):
        assert sorted(p.name for p in (tmp_path / d / "step_00000003").iterdir()) \
            == ["arrays.npz", "manifest.json"]
    a, _ = CheckpointManager(str(tmp_path / "r"), async_save=False).restore()
    b, _ = RCheckpointManager(str(tmp_path / "p"), async_save=False).restore()
    assert sorted(a) == sorted(b) == ["params/w", "step"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_restores_onto_the_target_leaf_dtype_and_requires_grad(tmp_path):
    from repro_torch.models.layers import Params

    p = Params({"w": torch.arange(4.0), "h": torch.ones(2, dtype=torch.bfloat16)})
    p.w.requires_grad_(True)
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(1, {"params": p})
    got, _ = ckpt.restore(target={"params": p})
    assert isinstance(got["params"], Params) and got["params"] is not p
    assert got["params"].w.requires_grad and not got["params"].h.requires_grad
    assert got["params"].h.dtype == torch.bfloat16
    assert torch.equal(got["params"].w, p.w) and torch.equal(got["params"].h, p.h)


@pytest.mark.parametrize("pkg", PKGS)
def test_data_deterministic_and_shifted(pkg):
    cls = RData if pkg == "repro" else SyntheticLMData
    d = cls(vocab_size=100, seq_len=16, global_batch=4, seed=1)
    np.testing.assert_array_equal(d.batch_at(3)["tokens"], d.batch_at(3)["tokens"])
    assert not np.array_equal(d.batch_at(0)["tokens"], d.batch_at(1)["tokens"])
    b = d.batch_at(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    kw = dict(vocab_size=100, seq_len=16, global_batch=8, host_count=2)
    d0, d1 = cls(host_index=0, **kw), cls(host_index=1, **kw)
    assert d0.local_batch == 4
    assert not np.array_equal(d0.batch_at(0)["tokens"], d1.batch_at(0)["tokens"])
    first = next(cls(vocab_size=50, seq_len=8, global_batch=2).iterate(start_step=5))
    np.testing.assert_array_equal(
        first["tokens"], cls(vocab_size=50, seq_len=8, global_batch=2).batch_at(5)["tokens"])


@pytest.mark.parametrize("kw", [
    dict(vocab_size=49155, seq_len=64, global_batch=4, seed=0),
    dict(vocab_size=512, seq_len=33, global_batch=6, seed=7, host_index=1, host_count=2),
    dict(vocab_size=512, seq_len=16, global_batch=2, seed=3, with_vision=4, d_model=8,
         with_frames=5)])
def test_data_batches_are_bit_equal_to_the_references(kw):
    r, p = RData(**kw), SyntheticLMData(**kw)
    for step in (0, 1, 17, 1000):
        a, b = r.batch_at(step), p.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("pkg", PKGS)
def test_compression_error_feedback_and_single_round(pkg):
    m = rcomp if pkg == "repro" else comp
    g = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    grads = {"w": _arr(pkg, g)}
    state = m.compression_init(grads)
    total = np.zeros(512)
    for _ in range(20):
        deq, state = m.compress_grads(grads, state)
        total = total + _np(deq["w"])
    rel = np.linalg.norm(total - 20 * g) / np.linalg.norm(20 * g)
    assert rel < 0.01
    g1 = {"w": _arr(pkg, np.random.default_rng(1).standard_normal(1024).astype(np.float32))}
    err = float(m.compression_error(g1, m.compression_init(g1)))
    assert 0 < err < 0.05


@pytest.mark.parametrize("pkg", PKGS)
def test_schedules_warmup_then_decay(pkg):
    f = rsched.linear_warmup_cosine if pkg == "repro" else sched.linear_warmup_cosine
    kw = dict(base_lr=1.0, warmup_steps=10, total_steps=100)
    lr0, lr10, lr99 = (float(f(s, **kw)) for s in (0, 10, 99))
    assert lr0 < lr10
    assert lr10 == pytest.approx(1.0, abs=0.01)
    assert lr99 < 0.2


# -- the two packages on the same inputs -----------------------------------------

@pytest.mark.parametrize("kw", [dict(base_lr=3e-4, warmup_steps=2, total_steps=300),
                                dict(base_lr=1.0, warmup_steps=10, total_steps=100),
                                dict(base_lr=3e-4, warmup_steps=100, total_steps=10000,
                                     min_ratio=0.0)])
def test_schedules_equal_the_references_in_float32(kw):
    def ulps(got, want):
        return abs(got - want) / float(np.spacing(np.float32(abs(want))))

    for step in range(301):
        want = np.asarray(rsched.linear_warmup_cosine(jnp.asarray(step, jnp.int32), **kw))
        got = sched.linear_warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        if step < kw["warmup_steps"]:
            assert got.item() == want.item(), step
        else:
            assert ulps(got.item(), want.item()) <= 4, step
    cos_kw = {k: v for k, v in kw.items() if k != "warmup_steps"}
    for step in range(0, 301, 7):
        want = float(rsched.cosine_schedule(jnp.asarray(step, jnp.int32), **cos_kw))
        got = sched.cosine_schedule(step, **cos_kw).item()
        assert ulps(got, want) <= 4, step


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"embed": {"embedding": rng.standard_normal((50, 16)).astype(np.float32)},
            "layers": {"w": (rng.standard_normal((3, 16, 8)) * 0.1).astype(np.float32),
                       "b": rng.standard_normal((3, 8)).astype(np.float32)},
            "norm": {"scale": rng.standard_normal(16).astype(np.float32)}}


def _port_flat(tree):
    """The reference tree as the port holds it: one tensor per layer,
    keyed by path ('layers/1/w')."""
    out = {}
    for k, leaf in ptree.flatten_with_paths(
            {a: {b: torch.from_numpy(v) for b, v in t.items()}
             for a, t in tree.items()}).items():
        if k.startswith("layers/"):
            for i in range(leaf.shape[0]):
                out[f"layers/{i}/{k.split('/', 1)[1]}"] = leaf[i].clone()
        else:
            out[k] = leaf.clone()
    return out


def _ref_flat(tree):
    """The reference's result tree in the port's keys."""
    flat = {}
    for k, leaf in ptree.flatten_with_paths(tree).items():
        leaf = np.asarray(leaf)
        if k.startswith("layers/"):
            for i in range(leaf.shape[0]):
                flat[f"layers/{i}/{k.split('/', 1)[1]}"] = leaf[i]
        else:
            flat[k] = leaf
    return flat


def _close(got: dict, want: dict, tol=TOL, scale=None):
    assert sorted(got) == sorted(want)
    if scale is None:
        scale = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0, atol=tol * scale,
                                   err_msg=k)


def _ref_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_grads_matches_the_reference(seed):
    grads = _random_tree(seed)
    r_state = rcomp.compression_init(_ref_jnp(grads))
    p_state = comp.compression_init(_port_flat(grads))
    for _ in range(3):
        r_deq, r_state = jax.jit(rcomp.compress_grads)(_ref_jnp(grads), r_state)
        p_deq, p_state = comp.compress_grads(_port_flat(grads), p_state)
        _close(p_deq, _ref_flat(r_deq))
        # The residual g - deq cancels: an ulp of the gradient (XLA may
        # fuse the subtraction into an FMA) is the scale to compare it at.
        _close(p_state.residual, _ref_flat(r_state.residual),
               scale=max(float(np.abs(g).max()) for g in _ref_flat(grads).values()))
    want = float(rcomp.compression_error(_ref_jnp(grads), r_state))
    got = float(comp.compression_error(_port_flat(grads), p_state))
    assert abs(got - want) <= TOL * want


@pytest.mark.parametrize("seed", [0, 1])
def test_global_norm_matches_the_reference(seed):
    tree = _random_tree(seed)
    want = float(radamw.global_norm(_ref_jnp(tree)))
    assert abs(float(adamw.global_norm(_port_flat(tree))) - want) <= TOL * want


@pytest.mark.parametrize("seed,max_norm", [(0, 1.0), (1, 1e3), (2, 0.05)])
def test_adamw_update_matches_the_reference(seed, max_norm):
    """Three updates from the same parameters and gradients: parameters,
    both moments and the gradient norm."""
    params = _random_tree(seed)
    rp, rs = _ref_jnp(params), radamw.adamw_init(_ref_jnp(params))
    pp = _port_flat(params)
    ps = adamw.adamw_init(pp)
    update = jax.jit(radamw.adamw_update, static_argnames=("max_grad_norm",))
    for t in range(3):
        grads = _random_tree(100 + 10 * seed + t)
        lr = np.float32(1e-3 * (t + 1))
        rp, rs, rm = update(_ref_jnp(grads), rs, rp, lr=jnp.asarray(lr),
                            max_grad_norm=max_norm)
        pp, ps, pm = adamw.adamw_update(_port_flat(grads), ps, pp,
                                        lr=torch.tensor(lr), max_grad_norm=max_norm)
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) \
            <= TOL * float(rm["grad_norm"])
        _close(pp, _ref_flat(rp))
        _close(ps.mu, _ref_flat(rs.mu))
        _close(ps.nu, _ref_flat(rs.nu))
        assert int(ps.step) == int(rs.step) == t + 1


def test_adamw_updates_a_module_in_place():
    from repro_torch.models.layers import Params

    p = Params({"w": torch.ones(3), "sub": {"b": torch.zeros(2)}})
    state = adamw.adamw_init(p)
    w_before = p.w
    grads = {"w": torch.full((3,), 0.5), "sub/b": torch.ones(2)}
    out, state, metrics = adamw.adamw_update(grads, state, p, lr=torch.tensor(0.1))
    assert out is p and p.w is w_before
    assert torch.all(p.w < 1) and torch.all(p.sub.b < 0)
    assert math.isclose(float(metrics["grad_norm"]), math.sqrt(3 * 0.25 + 2), rel_tol=1e-6)
    with pytest.raises(KeyError):
        adamw.adamw_update({"w": torch.ones(3)}, state, p, lr=torch.tensor(0.1))


def test_tree_helpers():
    from repro_torch.models.layers import Params
    from repro_torch.optim.adamw import AdamWState

    p = Params({"embed": {"embedding": torch.zeros(4, 2)},
                "layers": [{"w": torch.ones(2, 3)}, {"w": torch.ones(2, 3)}]})
    state = {"params": p, "opt": AdamWState(torch.tensor(1), {"a": torch.ones(2)},
                                            {"a": torch.ones(2)}), "comp": None}
    flat = ptree.flatten_with_paths(state)
    assert list(flat) == ["opt/step", "opt/mu/a", "opt/nu/a",
                          "params/embed/embedding", "params/layers/0/w",
                          "params/layers/1/w"]
    assert ptree.tree_num_params(p) == 8 + 12
    assert ptree.tree_size_bytes(p) == 4 * 20
    assert ptree.check_no_nans(state) == (True, "ok")
    p.layers[1].w.data[0, 0] = float("nan")
    assert ptree.check_no_nans(state) == (False, "non-finite values at params/layers/1/w")


def test_a_step_frees_its_gradients_without_the_cycle_collector():
    """`adamw_update` (through `global_norm` and `flatten_with_paths`)
    keeps no reference to the gradients it was given once it returns: a
    recursive closure in `flatten_with_paths` once held them in a
    reference cycle until the cyclic collector ran, a second set of
    gradients alive in every step (the VLM's training cut on the card ran
    out of memory for it).  With the collector off, the gradients die
    with the caller's last reference."""
    import gc
    import weakref

    params = {"w": torch.ones(3, 2), "b": [torch.zeros(2)]}
    state = adamw.adamw_init(params)
    grads = {"w": torch.full((3, 2), 0.5), "b/0": torch.ones(2)}
    refs = [weakref.ref(g) for g in grads.values()]
    gc.disable()
    try:
        adamw.adamw_update(grads, state, params, lr=torch.tensor(0.1))
        del grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
