"""Device resolution shared by every entry point of the port.

Entry points take ``device="cuda"`` by default and run on the card;
only an explicit ``device="cpu"`` runs on the host.  A CUDA request on a
machine without CUDA raises instead of falling back, so a measurement
path can never silently report host numbers as device numbers.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Canonical `torch.device` for ``device`` (``"cuda"`` → ``cuda:<current>``).

    Raises RuntimeError for a CUDA device when CUDA is unavailable.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                f"pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
