"""Device resolution shared by the port's entry points.

``device=None`` means the card. A missing card is an error, never a quiet
switch to the CPU: the CPU runs only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (None -> ``"cuda"``). Raises
    ``RuntimeError`` naming the device when it asks for CUDA and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
