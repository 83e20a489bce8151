"""The port stands alone: no JAX, nothing of the reference package, and
every entry point defaults to the card.

Parses every module of ``src/repro_torch``, ``chip_smoke.py``,
``compare_kernels.py``, ``compare_decode_steps.py`` and the port's examples (``examples/torch``) and fails on ``import jax`` / ``from jax …`` /
``import repro`` / ``from repro.…`` (``repro_torch`` itself is fine) and
on an import of the reference's ``benchmarks`` folder.  Then, with CUDA reported absent, each
entry point called with its default device must raise RuntimeError
instead of quietly running on the host.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "compare_kernels.py",
                                        ROOT / "compare_decode_steps.py"] \
    + sorted((ROOT / "examples" / "torch").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_has_the_slice_modules():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for mod in ("utils/logging.py", "utils/registry.py", "utils/lru.py",
                "utils/timing.py", "core/ir.py", "core/fusion.py",
                "core/features.py", "core/nas_space.py",
                "core/predictors/base.py", "core/predictors/trees.py",
                "core/predictors/gbdt.py", "core/predictors/random_forest.py",
                "core/predictors/flat.py", "core/composition.py",
                "core/dataset.py", "core/executor.py", "core/profiler.py",
                "kernels/tree_gather.py", "kernels/tree_gather_cuda.py",
                "kernels/_build.py", "kernels/ref.py", "kernels/ops.py",
                "kernels/int8_matmul.py", "kernels/int8_matmul_cuda.py",
                "kernels/winograd_conv.py", "kernels/winograd_conv_cuda.py",
                "quant/__init__.py", "quant/int8.py", "core/selection.py",
                "pipeline/store.py", "pipeline/hub.py", "pipeline/service.py",
                "convert.py", "configs/__init__.py", "configs/base.py",
                "configs/registry.py", "configs/paper_nas.py",
                "configs/granite_moe_1b.py", "configs/qwen2_72b.py",
                "rpc/__init__.py", "rpc/protocol.py", "rpc/batcher.py",
                "rpc/chaos.py", "rpc/client.py", "rpc/resilience.py",
                "rpc/server.py",
                "kernels/flash_attention.py", "kernels/flash_attention_cuda.py",
                "kernels/moe_gmm.py", "kernels/moe_gmm_cuda.py",
                "models/__init__.py", "models/layers.py", "models/attention.py",
                "models/moe.py", "models/transformer.py",
                "models/model_factory.py", "serving/__init__.py",
                "serving/engine.py", "kernels/ssd_scan.py", "models/encdec.py",
                "kernels/ssd_scan_cuda.py", "kernels/ssd_intra.py",
                "kernels/ssd_intra_cuda.py", "models/ssm.py", "models/hybrid.py",
                "core/predictors/lasso.py", "core/predictors/mlp.py",
                "core/realworld.py", "search/__init__.py", "search/pareto.py",
                "search/encoding.py", "search/objectives.py",
                "search/evolution.py", "transfer/__init__.py",
                "transfer/calibration.py", "transfer/descriptors.py",
                "transfer/sampler.py", "transfer/synthetic.py",
                "transfer/engine.py", "obs/__init__.py", "obs/metrics.py",
                "obs/tracing.py", "obs/export.py", "obs/drift.py",
                "obs/timeline.py", "obs/alerts.py", "obs/autopilot.py",
                "core/distributed_model.py", "core/cost_model.py",
                "distributed/__init__.py", "distributed/straggler.py",
                "utils/tree.py", "optim/__init__.py", "optim/schedules.py",
                "optim/adamw.py", "distributed/compression.py",
                "data/__init__.py", "data/pipeline.py", "checkpoint/__init__.py",
                "checkpoint/manager.py", "distributed/trainstep.py",
                "launch/__init__.py", "launch/train.py", "launch/serve.py",
                "launch/mesh.py", "distributed/sharding.py", "distributed/fsdp.py",
                "distributed/activations.py", "distributed/pipeline.py",
                "distributed/elastic.py", "launch/dryrun.py", "utils/hlo_analysis.py",
                "launch/roofline.py"):
        assert mod in names
    for src in ("tree_gather.cu", "int8_matmul.cu", "winograd_conv.cu",
                "flash_attention.cu", "flash_attention_bwd.cu", "moe_gmm.cu", "ssd_scan.cu",
                "ssd_intra.cu",
                "mma_bf16.cuh", "mma_s8.cuh", "ptx_copy.cuh", "host_launch.cuh"):
        assert (PORT / "kernels" / "csrc" / src).exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom repro.core import ir\n"
                 "import jax.numpy as jnp\nfrom . import x\n"
                 "from benchmarks.roofline import analytic_costs\n")
    roots = [m.split(".")[0] for _, m in _imported_roots(p)]
    assert [r for r in roots if r in FORBIDDEN] == ["repro", "jax", "benchmarks"]


def test_cuda_kernel_source_names_both_kernels():
    src = (PORT / "kernels" / "csrc" / "tree_gather.cu").read_text()
    for name in ("tree_gather_leaves", "tree_predict_fused",
                 "_tree_gather_kernel", "__fdiv_rn", "cudaGetLastError"):
        assert name in src


@pytest.mark.parametrize("source,names", [
    ("int8_matmul.cu", ("src/repro/kernels/int8_matmul.py", "_int8_mm_kernel",
                        "mma_s8_16832", "__int2float_rn", "__fmul_rn")),
    ("winograd_conv.cu", ("src/repro/kernels/winograd_conv.py",
                          "_winograd_kernel", "fmaf")),
    ("flash_attention.cu", ("src/repro/kernels/flash_attention.py",
                            "_flash_kernel", "expf", "__shfl_xor_sync")),
    ("flash_attention_bwd.cu", ("src/repro/models/attention.py", "naive_attention",
                                "expf", "fmaf", "__shfl_xor_sync")),
    ("moe_gmm.cu", ("src/repro/kernels/moe_gmm.py", "_gmm_kernel", "fmaf")),
    ("ssd_scan.cu", ("src/repro/kernels/ssd_scan.py", "_ssd_scan_kernel",
                     "__fmul_rn", "__fadd_rn")),
    ("ssd_intra.cu", ("src/repro/models/ssm.py", "ssd_forward", "expf", "fmaf",
                      "__shfl_xor_sync"))])
def test_cuda_sources_name_the_tpu_kernel_they_replace(source, names):
    src = (PORT / "kernels" / "csrc" / source).read_text()
    for name in names + ("What bounds it", "cudaGetLastError"):
        assert name in src
    for fast in ("tf32", "__fdividef", "__expf"):
        assert fast not in src


# -- default device is the card ---------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_gbdt():
    from repro_torch.core.predictors import GBDTPredictor

    rng = np.random.default_rng(0)
    x = rng.random((40, 3))
    return GBDTPredictor(n_stages=3, max_depth=2).fit(x, x.sum(1) + 1), x


def _graph():
    from repro_torch.core.dataset import synthetic_graphs

    return synthetic_graphs(1, resolution=16)[0]


def _linear():
    rng = np.random.default_rng(0)
    x = rng.random((40, 3))
    return x, x.sum(1) + 1


def _setting():
    from repro_torch.core.profiler import DeviceSetting

    return DeviceSetting("cpu_f32", "float32", "op_by_op")


def _store():
    """One graph profiled on the host."""
    from repro_torch.core.profiler import ProfileSession
    from repro_torch.pipeline import ProfileStore

    store = ProfileStore()
    ProfileSession(store=store, warmup=0, inner=1, repeats=1, e2e_inner=1,
                   e2e_repeats=1, device="cpu").profile_graph(_graph(), _setting())
    return store


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry_points():
    from repro_torch.core.executor import GraphExecutor, build_op_fn
    from repro_torch.core.predictors import LassoPredictor, MLPPredictor, load_predictor
    from repro_torch.core.profiler import ProfileSession
    from repro_torch.quant import build_quant_op_fn
    from repro_torch.kernels.tree_gather import CudaBank, to_device_scaler
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_reference, train_state_from_reference
    from repro_torch.distributed import init_train_state
    from repro_torch.distributed.elastic import plan_mesh
    from repro_torch.launch.dryrun import main as dryrun_main
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.pipeline import LatencyService, PredictorHub
    from repro_torch.rpc import LatencyRPCServer
    from repro_torch.serving import ServeEngine
    from repro_torch.utils.device import resolve_device

    lm = build_model(get_arch("qwen2-72b").reduced())
    ssm = build_model(get_arch("mamba2-2.7b").reduced())
    hybrid = build_model(get_arch("zamba2-1.2b").reduced())
    zoo = {arch: build_model(get_arch(arch).reduced()) for arch in
           ("gemma2-27b", "llama-3.2-vision-90b", "whisper-large-v3")}

    return {
        "resolve_device": lambda: resolve_device(),
        "GraphExecutor": lambda: GraphExecutor(_graph()),
        "build_op_fn": lambda: build_op_fn(_graph(), _graph().nodes[0]),
        "int8_GraphExecutor": lambda: GraphExecutor(_graph(), dtype="int8"),
        "whole_jit GraphExecutor": lambda: GraphExecutor(_graph(), mode="whole_jit"),
        "int8 whole_jit GraphExecutor": lambda: GraphExecutor(
            _graph(), mode="whole_jit", dtype="int8"),
        "build_quant_op_fn": lambda: build_quant_op_fn(_graph(), _graph().nodes[0]),
        "ProfileSession": lambda: ProfileSession(),
        "CudaBank": lambda: CudaBank.from_flat(_tiny_gbdt()[0].flat()),
        "to_device_scaler": lambda: to_device_scaler(_tiny_gbdt()[0].scaler),
        "LatencyService": lambda: LatencyService(PredictorHub()),
        "LatencyRPCServer": lambda: LatencyRPCServer(LatencyService(PredictorHub())),
        "predict_on_device": lambda: _tiny_gbdt()[0].predict_on_device(
            _tiny_gbdt()[1].astype(np.float32)),
        "predict_trees_cuda_tier": lambda: _tiny_gbdt()[0].flat().predict_trees(
            _tiny_gbdt()[1], backend="cuda"),
        "Model.init": lambda: lm.init(0),
        "Model.init_cache": lambda: lm.init_cache(1, 8),
        "ServeEngine": lambda: ServeEngine(lm, lm.init(0, device="cpu")),
        "ssm Model.init": lambda: ssm.init(0),
        "ssm Model.init_cache": lambda: ssm.init_cache(1, 8),
        "hybrid Model.init": lambda: hybrid.init(0),
        "hybrid Model.init_cache": lambda: hybrid.init_cache(1, 8),
        "hybrid ServeEngine": lambda: ServeEngine(hybrid, hybrid.init(0, device="cpu")),
        **{f"{arch} Model.init": (lambda m=m: m.init(0)) for arch, m in zoo.items()},
        **{f"{arch} Model.init_cache": (lambda m=m: m.init_cache(1, 8))
           for arch, m in zoo.items()},
        "init_train_state": lambda: init_train_state(lm, 0),
        "train driver": lambda: train_main(["--arch", "qwen2-72b-reduced", "--steps", "1"]),
        "serve driver": lambda: serve_main(["--arch", "qwen2-72b-reduced"]),
        "make_mesh": lambda: make_mesh((1,), ("data",)),
        "dry run": lambda: dryrun_main(["--arch", "qwen2-72b", "--shape", "decode_32k",
                                        "--mesh", "single"]),
        "quickstart example": lambda: _example("quickstart").main(["--graphs", "2"]),
        "serve_lm example": lambda: _example("serve_lm").main([]),
        "plan_mesh": lambda: plan_mesh(1),
        "train_state_from_reference": lambda: train_state_from_reference(
            {"params": {}, "opt": {"step": 0, "mu": {}, "nu": {}}, "step": 0},
            get_arch("qwen2-72b").reduced()),
        "lm_params_from_reference": lambda: lm_params_from_reference(
            {"layers": {"w": np.zeros((4, 2))}}, get_arch("qwen2-72b").reduced()),
        "LassoPredictor": lambda: LassoPredictor(),
        "MLPPredictor": lambda: MLPPredictor(),
        "load_predictor(lasso)": lambda: load_predictor(
            LassoPredictor(device="cpu").fit(*_linear()).to_json()),
        "PredictorHub.train(mlp)": lambda: PredictorHub().train(
            _store(), _setting(), "mlp", hparams={"max_epochs": 5}),
        "load_predictor(calibrated lasso)": lambda: load_predictor(
            _calibrated_lasso_json()),
    }


def _calibrated_lasso_json():
    from repro_torch.core.predictors import LassoPredictor
    from repro_torch.transfer import CalibratedPredictor, scale_map

    base = LassoPredictor(device="cpu").fit(*_linear())
    return CalibratedPredictor.wrap(base, scale_map(2.0)).to_json()


@pytest.mark.parametrize("name", list(_entry_points()))
def test_default_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_explicit_cpu_runs_on_the_host(no_cuda):
    from repro_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    model, x = _tiny_gbdt()
    assert model.predict_on_device(x.astype(np.float32), device="cpu").shape == (40,)


def test_unknown_device_type_rejected():
    from repro_torch.utils.device import resolve_device

    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


# -- chip_smoke refuses to run where it cannot measure ---------------------------

def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
