"""Device resolution for the port's entry points.

Entry points run on the card by default. A caller that wants the CPU (the
parity tests) asks for it explicitly; a missing card is an error, never a
silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for (or
    implied) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lvd_tpu_torch: no CUDA device found; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev


def sync(device: torch.device) -> None:
    """Waits for the card, so a timed phase's seconds hold its device work;
    nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
