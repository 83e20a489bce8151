"""The port's nvcc build helper (repro_torch.kernels._build), on the host.

A library's file name is a hash of its sources, the headers they include
and nvcc's flags, so an edit to a shared header builds a new library
instead of loading a stale one from ``build/``.  Nothing here needs nvcc.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention_cuda, moe_gmm_cuda  # noqa: E402

TENSOR_CORE_MODULES = (flash_attention_cuda, moe_gmm_cuda)


def _library(headers=()):
    return _build.CudaLibrary("k", ("k.cu",), lambda lib: None, headers=headers)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    return tmp_path


def test_header_bytes_are_hashed_into_the_library_name(csrc):
    lib = _library(("h.cuh",))
    first = lib.path()
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk_")
    assert lib.path() == first
    (csrc / "h.cuh").write_text("// two\n")
    assert lib.path() != first
    (csrc / "h.cuh").write_text("// one\n")
    assert lib.path() == first
    assert _library().path() != first


def test_headers_are_not_passed_to_nvcc(csrc, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _library(("h.cuh",))._command(csrc / "out.so")
    assert str(csrc / "k.cu") in cmd
    assert not any("h.cuh" in arg for arg in cmd)


@pytest.mark.parametrize("module", TENSOR_CORE_MODULES, ids=lambda m: m.__name__)
def test_tensor_core_sources_hash_the_shared_header(module):
    assert module.LIBRARY.headers == ("mma_bf16.cuh",)
    src = (_build.CSRC / module.LIBRARY.sources[0]).read_text()
    assert '#include "mma_bf16.cuh"' in src


def test_shared_header_holds_the_ptx_wrappers():
    src = (_build.CSRC / "mma_bf16.cuh").read_text()
    for name in ("cp_async_16", "cp_async_commit", "cp_async_wait",
                 "ldmatrix_x4", "ldmatrix_x4_trans", "mma_bf16_16816",
                 "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                 "cp.async.cg.shared.global", ".trans"):
        assert name in src


@pytest.mark.parametrize("module", TENSOR_CORE_MODULES, ids=lambda m: m.__name__)
def test_routes_are_chosen_by_dtype_and_reset_with_the_launch_count(module):
    assert {dt: r for dt, (_, r) in module.ROUTES.items()} == {
        torch.bfloat16: "bf16_mma", torch.float32: "f32_simt"}
    assert set(module.route_counts()) == {"bf16_mma", "f32_simt"}
    module._ROUTE_COUNTER.add("bf16_mma")
    module.reset_launch_counts()
    assert module.route_counts() == {"bf16_mma": 0, "f32_simt": 0}
    assert set(module.launch_counts().values()) == {0}
