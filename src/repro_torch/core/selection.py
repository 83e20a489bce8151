"""Kernel-selection rules — faithful port of paper Algorithm C.2 + TPU rules.

A copy of the reference's ``repro.core.selection`` with only its import
paths changed.  The paper deduces which OpenCL kernel TFLite's GPU
delegate picks for each convolution — {Conv2D, Winograd, GroupedConv2D} —
from op parameters and the target GPU family (Adreno / Mali / PowerVR /
AMD), WITHOUT deploying on the device.  The rules are ported
line-by-line, and the reference extends the same mechanism to a TPU-v5e
profile that selects among its kernels (flash-attention vs naive
attention, int8 vs bf16 matmul, fused MoE GMM vs per-expert loop,
Winograd vs direct conv) from matrix-unit alignment.  The profiles'
fields are copied as data.  The port adds one profile of its own, the
H100 (``"h100"``), which runs Alg. C.2's generic rules and selects no
Winograd kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

from repro_torch.core.ir import OpGraph, OpNode, make_params

# ---------------------------------------------------------------------------
# Device profiles
# ---------------------------------------------------------------------------

GPU_ADRENO6XX = "adreno6xx"   # e.g. Adreno 640 / 616 (Snapdragon 855 / 710)
GPU_ADRENO = "adreno"         # other Adreno
GPU_AMD = "amd"
GPU_MALI = "mali"             # e.g. Mali G76 (Exynos 9820)
GPU_POWERVR = "powervr"       # e.g. PowerVR GE8320 (Helio P35)
TPU_V5E = "tpu_v5e"
CPU_XLA = "cpu_xla"           # the reference's CPU device
GPU_H100 = "h100"             # the port's card (NVIDIA H100 SXM)


@dataclass(frozen=True)
class DeviceProfile:
    """Hardware identity + rates used by selection rules and cost models."""

    name: str
    kind: str                      # one of the GPU_*/TPU_*/CPU_* constants
    peak_flops: float = 0.0        # FLOP/s (bf16 for TPU)
    peak_int8_flops: float = 0.0
    hbm_bw: float = 0.0            # bytes/s
    link_bw: float = 0.0           # bytes/s per ICI link
    vmem_bytes: int = 0
    mxu_dim: int = 128
    cores: int = 1                 # compute cores the runtime schedules on
    freq_ghz: float = 0.0          # nominal clock (0 = unknown)
    supports_fusion: bool = True
    supports_winograd: bool = True


DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    "adreno640": DeviceProfile("adreno640", GPU_ADRENO6XX),
    "adreno616": DeviceProfile("adreno616", GPU_ADRENO6XX),
    "mali_g76": DeviceProfile("mali_g76", GPU_MALI),
    "powervr_ge8320": DeviceProfile("powervr_ge8320", GPU_POWERVR),
    "tpu_v5e": DeviceProfile(
        "tpu_v5e", TPU_V5E,
        peak_flops=197e12, peak_int8_flops=394e12,
        hbm_bw=819e9, link_bw=50e9,
        vmem_bytes=128 * 1024 * 1024, mxu_dim=128,
    ),
    # supports_winograd=False: the reference's CPU profile never selects
    # Winograd (kernel selection is hardware-dependent, paper Insight 4).
    "cpu_xla": DeviceProfile(
        "cpu_xla", CPU_XLA,
        peak_flops=50e9, hbm_bw=10e9, link_bw=1e9,
        cores=1, freq_ghz=2.2,
        supports_winograd=False,
    ),
    # The port's card: NVIDIA H100 80GB HBM3 at its 700.00 W power limit
    # (nvidia-smi --query-gpu=name,power.limit).  Published dense rates:
    # bfloat16 on the tensor cores (the field's convention for peak_flops;
    # float32 outside them is 67e12), int8 on the tensor cores, HBM3.
    # supports_winograd=False: the paper's Fig. 8 study on this card found
    # the direct convolution faster than the port's Winograd kernel at all
    # three ResNet shapes (chip_smoke.py `fig8` lines; PERF.md).
    "h100": DeviceProfile(
        "h100", GPU_H100,
        peak_flops=989e12, peak_int8_flops=1979e12,
        hbm_bw=3.35e12,
        supports_winograd=False,
    ),
}


def get_device(name: str) -> DeviceProfile:
    if name not in DEVICE_PROFILES:
        raise KeyError(f"unknown device {name!r}; known: {sorted(DEVICE_PROFILES)}")
    return DEVICE_PROFILES[name]


# ---------------------------------------------------------------------------
# Paper Algorithm C.2 — faithful port (line numbers refer to Alg. C.2)
# ---------------------------------------------------------------------------

def check_grouped_conv2d(device: DeviceProfile, node: OpNode, graph: OpGraph) -> bool:
    """CheckGroupedConv2D — L6-10."""
    groups = node.param("groups", 1)
    in_c = graph.tensor(node.inputs[0]).shape[-1]
    out_c = graph.tensor(node.outputs[0]).shape[-1]
    src_group_size = in_c                                   # L6 (per TFLite source)
    dst_group_size = out_c // max(1, groups)                # L7
    return groups != 1 and src_group_size % 4 == 0 and dst_group_size % 4 == 0  # L8


def check_winograd(device: DeviceProfile, node: OpNode, graph: OpGraph) -> bool:
    """CheckWinograd — L11-28, with the paper's per-GPU-family thresholds."""
    groups = node.param("groups", 1)
    kh, kw = node.param("kernel_h", 1), node.param("kernel_w", 1)
    stride = node.param("stride", 1)
    if groups != 1 or (kh, kw) != (3, 3) or stride != 1:    # L11-12
        return False
    in_c = graph.tensor(node.inputs[0]).shape[-1]
    out_shape = graph.tensor(node.outputs[0]).shape
    out_h, out_w, out_c = out_shape[-3], out_shape[-2], out_shape[-1]
    src_depth = math.ceil(in_c / 4)                         # L13
    dst_depth = math.ceil(out_c / 4)                        # L14
    if device.kind in (GPU_ADRENO, GPU_ADRENO6XX):
        if src_depth < 32 or dst_depth < 32:                # L15-16
            return False
    elif device.kind == GPU_AMD:
        if src_depth < 16 or dst_depth < 8:                 # L17-18
            return False
    else:                                                   # Mali / PowerVR / other
        if src_depth < 16 or dst_depth < 16:                # L19-20
            return False
    total_tiles = math.ceil(out_h / 4) * math.ceil(out_w / 4)  # L21
    if device.kind == GPU_ADRENO6XX:
        if total_tiles < 128:                               # L22-23
            return False
    elif device.kind == GPU_ADRENO:
        if total_tiles < 64:                                # L24-25
            return False
    else:
        if total_tiles < 32:                                # L26-27
            return False
    return True                                             # L28


def _check_winograd_tpu(device: DeviceProfile, node: OpNode, graph: OpGraph) -> bool:
    """TPU analogue of CheckWinograd.

    Winograd F(2x2,3x3) trades 2.25x fewer MACs for transform overhead.
    Mirrors the structure of Alg. C.2 with thresholds derived from a
    128x128 matrix unit.
    """
    groups = node.param("groups", 1)
    kh, kw = node.param("kernel_h", 1), node.param("kernel_w", 1)
    stride = node.param("stride", 1)
    if groups != 1 or (kh, kw) != (3, 3) or stride != 1:
        return False
    in_c = graph.tensor(node.inputs[0]).shape[-1]
    out_shape = graph.tensor(node.outputs[0]).shape
    out_h, out_w, out_c = out_shape[-3], out_shape[-2], out_shape[-1]
    # MXU wants >=1/2-full 128-lanes on both contraction and output dims.
    if in_c < 64 or out_c < 64:
        return False
    total_tiles = math.ceil(out_h / 2) * math.ceil(out_w / 2)  # F(2x2): 2x2 tiles
    return total_tiles >= 128


def select_conv_kernel(device: DeviceProfile, node: OpNode, graph: OpGraph) -> str:
    """SelectConv2DKernel — Alg. C.2 L1-5 (+ TPU profile)."""
    if node.op_type == "dwconv2d":
        return "dwconv2d"
    if device.kind == TPU_V5E:
        if check_grouped_conv2d(device, node, graph):
            return "grouped_conv2d"
        if _check_winograd_tpu(device, node, graph):
            return "winograd_conv2d"
        return "conv2d"
    if check_grouped_conv2d(device, node, graph):           # L1-2
        return "grouped_conv2d"
    if device.supports_winograd and check_winograd(device, node, graph):  # L3-4
        return "winograd_conv2d"
    return "conv2d"                                          # L5


# ---------------------------------------------------------------------------
# TPU LM-graph kernel selection (beyond-paper, same mechanism)
# ---------------------------------------------------------------------------

def select_attention_kernel(device: DeviceProfile, node: OpNode) -> str:
    """Select flash vs naive attention (TPU analogue of Winograd selection).

    Flash attention's Pallas kernel requires MXU-aligned head_dim (mult of
    128 lanes) and long-enough sequences to amortize the softmax-rescaling
    recurrence; short sequences or tiny head dims run the naive kernel.
    """
    if device.kind != TPU_V5E:
        return "attention"
    head_dim = node.param("head_dim", 64)
    q_len = node.param("q_len", 1)
    window = node.param("window", 0)
    if head_dim % 128 != 0 and head_dim < 64:
        return "attention"
    if q_len < 128:
        return "attention"          # decode single-token: naive dot is optimal
    if window:
        return "window_attention"
    return "flash_attention"


def select_matmul_kernel(device: DeviceProfile, node: OpNode, quantized: bool) -> str:
    if device.kind == TPU_V5E and quantized:
        m, n, k = node.param("m", 1), node.param("n", 1), node.param("k", 1)
        # int8 MXU path needs 32-aligned contraction dim.
        if k % 32 == 0 and n % 32 == 0:
            return "int8_matmul"
    return "matmul"


def apply_selection(graph: OpGraph, device: DeviceProfile,
                    quantized: bool = False) -> OpGraph:
    """Rewrite op types per the device's kernel-selection rules.

    Mirrors paper §4.1 step (2): deduce the kernels actually executed for
    (graph, device) without touching hardware.  Returns a new graph.
    """
    out = OpGraph(graph.name + f":{device.name}")
    out.tensors = dict(graph.tensors)
    out._next_tensor = graph._next_tensor
    out.input_ids = list(graph.input_ids)
    out.output_ids = list(graph.output_ids)
    out._next_op = graph._next_op
    for node in graph.nodes:
        new = node
        if node.op_type in ("conv2d", "grouped_conv2d", "winograd_conv2d", "dwconv2d"):
            # Selection starts from the *operation* (generic conv); re-derive.
            kind = select_conv_kernel(device, node, graph)
            new = node.with_type(kind)
        elif node.op_type in ("attention", "flash_attention", "window_attention"):
            new = node.with_type(select_attention_kernel(device, node))
        elif node.op_type == "matmul":
            new = node.with_type(select_matmul_kernel(device, node, quantized))
        out.nodes.append(new)
    return out


def selection_summary(graph: OpGraph, device: DeviceProfile) -> Dict[str, int]:
    sel = apply_selection(graph, device)
    return sel.op_type_counts()
