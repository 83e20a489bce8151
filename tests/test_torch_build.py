"""The port's nvcc build helper (repro_torch.kernels._build), on the host.

A library's file name is a hash of its sources, the headers they include
and nvcc's flags, so an edit to a shared header builds a new library
instead of loading a stale one from ``build/``.  Nothing here needs nvcc.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import (flash_attention_cuda, int8_matmul_cuda,  # noqa: E402
                                 moe_gmm_cuda, ssd_intra_cuda, ssd_scan_cuda,
                                 tree_gather_cuda, winograd_conv_cuda)

TENSOR_CORE_MODULES = (flash_attention_cuda, moe_gmm_cuda)
CUDA_MODULES = (tree_gather_cuda, int8_matmul_cuda, winograd_conv_cuda,
                flash_attention_cuda, moe_gmm_cuda, ssd_scan_cuda, ssd_intra_cuda)
COPY_WRAPPERS = ("smem_addr", "cp_async_16", "cp_async_4", "cp_async_commit",
                 "cp_async_wait", "ldmatrix_x4", "ldmatrix_x4_trans", "ldmatrix_x2")


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
    assert module.LIBRARY.headers == ("mma_bf16.cuh", "ptx_copy.cuh", "host_launch.cuh")
    src = (_build.CSRC / module.LIBRARY.sources[0]).read_text()
    assert '#include "mma_bf16.cuh"' in src


def test_shared_header_holds_the_ptx_wrappers():
    # The bf16 header keeps its mma and includes the copy wrappers, which
    # live in one header for every kernel.
    src = (_build.CSRC / "mma_bf16.cuh").read_text()
    for name in ("mma_bf16_16816", '#include "ptx_copy.cuh"',
                 "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"):
        assert name in src
    src = (_build.CSRC / "ptx_copy.cuh").read_text()
    for name in COPY_WRAPPERS + ("cp.async.cg.shared.global",
                                 "cp.async.ca.shared.global", ".trans"):
        assert name in src


def _includes(name):
    """The csrc headers a source or header includes, directly or not."""
    found = set()
    for inc in re.findall(r'#include "([^"]+)"', (_build.CSRC / name).read_text()):
        found |= {inc} | _includes(inc)
    return found


LIBRARIES = [lib for m in CUDA_MODULES for lib in getattr(m, "LIBRARIES", (m.LIBRARY,))]


def test_every_source_has_a_library():
    assert sorted(s for lib in LIBRARIES for s in lib.sources) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    assert flash_attention_cuda.BWD_LIBRARY.headers == (
        "mma_bf16.cuh", "ptx_copy.cuh", "host_launch.cuh")


@pytest.mark.parametrize("lib", LIBRARIES, ids=lambda lib: lib.name)
def test_every_included_header_is_hashed_into_the_library_name(lib):
    included = set().union(*(_includes(src) for src in lib.sources))
    assert set(lib.headers) == included


@pytest.mark.parametrize("name", sorted(p.name for p in _build.CSRC.iterdir()
                                        if p.suffix in (".cu", ".cuh")))
def test_copy_wrappers_are_defined_in_one_header(name):
    src = (_build.CSRC / name).read_text()
    defined = set(re.findall(r"__device__ (?:__forceinline__ )?\w+ (\w+)\(", src))
    if name == "ptx_copy.cuh":
        assert set(COPY_WRAPPERS) <= defined
    else:
        assert not defined & set(COPY_WRAPPERS)


@pytest.mark.parametrize("module", TENSOR_CORE_MODULES, ids=lambda m: m.__name__)
def test_routes_are_chosen_by_dtype_and_reset_with_the_launch_count(module):
    assert {dt: r for dt, (_, r) in module.ROUTES.items()} == {
        torch.bfloat16: "bf16_mma", torch.float32: "f32_simt"}
    assert set(module.route_counts()) == {"bf16_mma", "f32_simt"}
    module._ROUTE_COUNTER.add("bf16_mma")
    module.reset_launch_counts()
    assert module.route_counts() == {"bf16_mma": 0, "f32_simt": 0}
    assert set(module.launch_counts().values()) == {0}


def test_backward_routes_are_counted_apart_and_reset_with_the_launch_count():
    module = flash_attention_cuda
    assert set(module.bwd_route_counts()) == {"bf16_mma", "f32_simt"}
    assert module._BWD_ROUTE_COUNTER.routes
    assert any(c is module._BWD_ROUTE_COUNTER for c in _build._COUNTERS)
    module._BWD_ROUTE_COUNTER.add("bf16_mma")
    assert module.route_counts()["bf16_mma"] == 0      # the forward's routes
    module.reset_launch_counts()
    assert module.bwd_route_counts() == {"bf16_mma": 0, "f32_simt": 0}


def _code(name: str) -> str:
    """A csrc file without its ``//`` comments."""
    return re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())


def _kernel_body(src: str, name: str) -> str:
    """The body of the ``__global__`` function ``name`` (braces balanced)."""
    start = src.index("{", re.search(rf"__global__[^;{{]*\b{name}\(", src).end())
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(name)


@pytest.mark.parametrize("kernel,mmas", [("flash_bwd_dq_bf16_mma", 8),
                                         ("flash_bwd_dkdv_bf16_mma", 8)])
def test_bf16_backward_multiplies_on_the_tensor_cores_in_registers(kernel, mmas):
    """Every product of the bfloat16 backward is an m16n8k16 mma (dq: S,
    dP, dQ, dP at two call sites, from dO's fragments held in registers
    or, in a masked instance at D = 128, read again from shared memory;
    dk/dv: S^T, dP^T, dV, dK; two n-blocks a call site); P and dS reach
    the next product as A fragments (no store of a score tile to shared
    memory), and nothing adds atomically or calls a library."""
    src = _code("flash_attention_bwd.cu")
    body = _kernel_body(src, kernel)
    assert body.count("mma_bf16_16816(") == mmas
    assert "c_to_a(" in body
    # The only shared-memory writes are cp.async copies and the final
    # staging of dQ / dK / dV rows (store_rows).
    assert "reinterpret_cast<uint32_t*>" not in body
    assert re.search(r"\b(qs|dos|ks|vs|ls|dl)\[[^\]]*\]\s*=", body) is None
    for word in ("atomic", "cublas", "cudnn", "cutlass", "#include <"):
        assert word not in src.lower().replace("#include <cuda_bf16.h>", "").replace(
            "#include <cuda_runtime.h>", "").replace("#include <stdint.h>", "")


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_bwd_dq_bf16_mmaILi64EEEvPK13__nv_bfloat16S3_S3_S3_S3_PKfPfPS1_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_bwd_dq_bf16_mmaILi64EEEvPK13__nv_bfloat16S3_S3_S3_S3_PKfPfPS1_iiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_bwd_dqIfLi128EEEvPKT_S3_S3_S3_S3_PKfPfPS1_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_bwd_dqIfLi128EEEvPKT_S3_S3_S3_S3_PKfPfPS1_iiiiiif
    8 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 420 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    report = _build.ptxas_report(PTXAS)
    assert sorted(report.values(), key=lambda r: r["registers"]) == [
        {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        {"registers": 255, "spill_stores": 24, "spill_loads": 16}]
    assert _build.ptxas_report("") == {}


# -- launches recorded by a CUDA-graph capture count at each replay ---------------

def test_captured_launches_move_from_the_capture_to_the_replays():
    kernels = _build.LaunchCounter("k")
    routes = _build.LaunchCounter("a", "b", routes=True)
    kernels.add("k")                          # a launch before the capture ran
    captured = []
    with _build.capturing_launches(captured):
        kernels.add("k")
        kernels.add("k")
        routes.add("b")
    assert kernels.snapshot() == {"k": 1} and routes.snapshot() == {"a": 0, "b": 0}
    assert sorted((c.routes, name, n) for c, name, n in captured) == [
        (False, "k", 2), (True, "b", 1)]
    _build.add_launches(captured)
    _build.add_launches(captured, times=3)
    assert kernels.snapshot() == {"k": 9} and routes.snapshot() == {"a": 0, "b": 4}


def test_a_failed_capture_counts_nothing():
    kernels = _build.LaunchCounter("k")
    captured = []
    with pytest.raises(RuntimeError):
        with _build.capturing_launches(captured):
            kernels.add("k")
            raise RuntimeError("capture refused")
    assert kernels.snapshot() == {"k": 0} and captured[0][1:] == ("k", 1)


@pytest.mark.parametrize("module", CUDA_MODULES, ids=lambda m: m.__name__)
def test_every_wrapper_counter_is_registered_for_captures(module):
    counters = [module._COUNTER] + ([module._ROUTE_COUNTER]
                                    if hasattr(module, "_ROUTE_COUNTER") else [])
    for c in counters:
        assert any(c is r for r in _build._COUNTERS)
    assert not module._COUNTER.routes
    assert all(c.routes for c in counters[1:])
