"""Where the port's entry points run: the card unless the caller names
another device.  Shared by the engine, the decode lane and ``Model``."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent.
    On the card, fp32 products and convolutions are held to full fp32
    (TF32 off), as the reference computes them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
