"""Explicit device selection (the port's counterpart of utils/jaxenv.py).

The port never picks a device behind the caller's back: ``cuda`` means the
card, and asking for it on a host without one is an error, not a silent
CPU run.
"""

from __future__ import annotations

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
