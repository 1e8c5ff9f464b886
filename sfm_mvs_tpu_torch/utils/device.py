"""The device rule of the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall back to it."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a usable GPU raises
    (the Python API runs on the card unless the caller asks for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: CUDA is not available on this machine "
                           "(pass device=\"cpu\" to run on the CPU)")
    return dev
