"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``. Asking for the card where there is
none raises: the port never carries on on the CPU unless the caller asks
for the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the card's queued work, so a host clock reads it; a no-op
    on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
