"""Device choice shared by the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means ``"cuda"``, and a missing card is an error, never
a silent move to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The torch device to run on: ``cuda`` unless ``device`` says
    ``cpu``.  Raises when CUDA is asked for (or defaulted to) and no
    card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; this package runs on the GPU "
            "unless the caller passes device='cpu'")
    return dev
