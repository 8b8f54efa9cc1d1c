"""Explicit device selection (the port's counterpart of utils/jaxenv.py).

The port never picks a device behind the caller's back: ``cuda`` means the
card, and asking for it on a host without one is an error, not a silent
CPU run.
"""

from __future__ import annotations

import os

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> torch.device; raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False (no CPU fallback)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def available_bytes(device: torch.device) -> int:
    """Bytes a new allocation on ``device`` can still take: on a card the
    driver's free memory plus what torch's caching allocator holds but no
    tensor uses; on the CPU the host's available physical memory."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free + torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
