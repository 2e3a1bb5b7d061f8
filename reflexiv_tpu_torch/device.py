"""Explicit device selection.

Every public entry of the port takes a ``device``. ``cuda`` means the card:
if PyTorch sees no CUDA device it raises, and nothing here ever picks the
CPU in its place. Tests pass ``"cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``"cuda"``, ``"cuda:N"``, ``"cpu"`` or a ``torch.device`` -> a
    ``torch.device``; raises if the device is not usable."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False (use -device cpu to run on the CPU)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r}: only {torch.cuda.device_count()} "
                "CUDA device(s) present")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (stage timers read a host clock)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
