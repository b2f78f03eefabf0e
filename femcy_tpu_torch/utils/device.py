"""The device rule of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, "cpu" or "cuda" only.  A CUDA device
    without a card raises: the port never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; femcy_tpu_torch never falls back to the CPU (pass "
            "device='cpu' to run there)"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device
