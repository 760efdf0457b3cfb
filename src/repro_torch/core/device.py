"""Explicit device resolution: the port never moves to the CPU by itself."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda", meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises where ``cuda`` is asked for
    and no card is visible.  Only ``cuda`` and ``cpu`` are served, and
    ``meta`` (shapes and dtypes, no storage) where ``meta`` is set."""
    dev = torch.device(device)
    if meta and dev.type == "meta":
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but torch sees no CUDA card; pass "
                "device='cpu' to run the plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
