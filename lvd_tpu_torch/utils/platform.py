"""Where the port's CLIs run (counterpart of lvd_tpu/utils/platform.py).

``LVD_PLATFORM=cpu`` is lvd_tpu's explicit request for the CPU, and here it
runs the CLIs on the plain PyTorch path there. Without ``LVD_PLATFORM``, or
with ``gpu`` or ``cuda``, they run on the card, and a missing card raises
(utils/device.py); any other value raises. lvd_tpu's persistent compile
cache has no counterpart: nothing in the port compiles per run.
"""

from __future__ import annotations

import os

import torch

from .device import resolve_device

_DEVICES = {"": None, "gpu": None, "cuda": None, "cpu": "cpu"}


def _requested():
    plat = os.environ.get("LVD_PLATFORM", "").lower()
    if plat not in _DEVICES:
        raise ValueError(f"LVD_PLATFORM={plat!r}: the port runs on 'cpu' or the card "
                         "('gpu', 'cuda', or unset)")
    return _DEVICES[plat]


def maybe_force_platform():
    """Checks ``LVD_PLATFORM`` where lvd_tpu's CLIs read it, before any work."""
    _requested()


def device() -> torch.device:
    """The device ``LVD_PLATFORM`` asks for (the card unless ``cpu``)."""
    return resolve_device(_requested())
