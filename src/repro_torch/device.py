"""Device choice shared by the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means ``"cuda"``, and a missing card is an error, never
a silent move to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "fake_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The torch device to run on: ``cuda`` unless ``device`` says
    ``cpu`` (or ``meta`` under a ``FakeTensorMode``, where the dry run's
    fake tensors lie without a card: :func:`fake_device`).  Raises when
    CUDA is asked for (or defaulted to) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "meta":          # the dry run's fake tensors only
        from torch._guards import detect_fake_mode
        if detect_fake_mode() is not None:
            return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; this package runs on the GPU "
            "unless the caller passes device='cpu'")
    return dev


def fake_device() -> torch.device:
    """The device of the dry run's fake tensors: ``cuda`` where a card is
    visible, else ``meta``, since a CPU-only torch cannot index a fake
    CUDA tensor (its Python indexing asks for a CUDA device guard).  On
    either, the kernels' wrappers take their card path, where a fake
    tensor meets the kernel's fake form; nothing is allocated."""
    return torch.device("cuda" if torch.cuda.is_available() else "meta")
