"""Device rule of the port: ``cuda`` unless the caller asks for ``cpu``.

There is no silent fallback: an entry point called without a device on a
machine with no GPU raises, it does not run on the CPU instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_parity_precision() -> None:
    """Full-f32 matmuls and convolutions (TF32 off for both), as parity
    checks against an f32 reference need."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
