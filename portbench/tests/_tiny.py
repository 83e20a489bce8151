"""Cells cut to a size a CPU test holds: the committed cells' files with
their widths, depths and batches made small."""
from __future__ import annotations

import sys

from portbench import core

if str(core.REPO / "src") not in sys.path:
    sys.path.append(str(core.REPO / "src"))

TINY = {
    "moe": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=32, vocab_size=256, num_experts=8, top_k=2),
    "ssm": dict(num_layers=2, d_model=64, vocab_size=256, ssm_state=16, ssm_head_dim=16,
                ssm_chunk=16),
}

CELLS = {"moe": "granite-moe-1b.train.4x4096", "ssm": "mamba2-2.7b.train.2x2048"}


def tiny_cell(family: str, compute_dtype: str = "float32") -> core.Cell:
    cell = core.load_cell(CELLS[family])
    arch = dict(cell.config["arch"], **TINY[family], compute_dtype=compute_dtype)
    cell.config = dict(cell.config, arch=arch)
    cell.traffic = dict(cell.traffic, batch=2, seq=64)
    return cell
