"""Device selection shared by every entry point that touches a tensor."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU (``torch.device("cuda")``).  Asking for the
    GPU where ``torch.cuda.is_available()`` is false raises a
    ``RuntimeError``; nothing moves to the CPU unless the caller passes
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """``cuda`` and ``cuda:<current>`` name the same card."""
    if b is None or a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (
        b.index if b.index is not None else cur)
