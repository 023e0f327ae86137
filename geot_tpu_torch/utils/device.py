"""Device resolution for the port's entry points.

The default is the CUDA card. The CPU is used only when the caller asks
for it (the CPU tests do); asking for CUDA where there is none raises —
there is no silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means "cuda". Raises RuntimeError if CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "geot_tpu_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run the plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
