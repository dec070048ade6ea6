"""Device selection for every entry point of the port.

The port runs on a CUDA card unless the caller asks for the CPU
explicitly; it never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked.  Raises when a CUDA
    device is wanted and none is available.

    On CUDA, float32 matrix products and convolutions are pinned to full
    float32 (TF32 off): serving scores and the hub-row product must match
    the CPU reference to 1e-5, and TF32 keeps about three digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
