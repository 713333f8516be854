"""Device resolution for every entry point of the port.

The rule: an entry point runs on the card unless the caller asks for
the CPU.  ``device=None`` means ``cuda``; asking for ``cuda`` on a
machine without a card raises instead of falling back to the CPU, so a
run that was meant for the card can never quietly measure the host.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "sm_count"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises
    ``RuntimeError``; anything else is returned as a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels'
    wrappers size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
