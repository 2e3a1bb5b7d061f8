"""Which aux stages run their device form (``reflexiv_tpu.device_aux``).

The JAX module's two-limb binary search and ragged range expansion were
TPU workarounds (no int64 there); the port searches int64 keys with
``torch.searchsorted`` and expands ranges with ``torch.repeat_interleave``.
"""
from __future__ import annotations

import os


def device_stage_default(stage: str) -> bool:
    """Whether ``stage`` (``"end_extend"``, ``"correction"``,
    ``"patching"``) runs its device form. ``REFLEXIV_DEVICE_STAGES`` decides
    for every stage: ``"0"`` the numpy oracles, any other value the device.
    Unset, only ``end_extend`` runs on the device; correction and patching
    keep their native C++ forms."""
    env = os.environ.get("REFLEXIV_DEVICE_STAGES")
    if env is not None:
        return env != "0"
    return stage == "end_extend"
