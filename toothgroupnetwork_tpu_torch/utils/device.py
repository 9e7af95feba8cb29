"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The named device; raises if it is a CUDA device and there is no card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device
