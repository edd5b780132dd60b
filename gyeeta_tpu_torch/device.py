"""Device resolution for the port's entry points.

The default is the GPU. Nothing falls back to the CPU on its own: the
CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do, and then every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` → ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    # "meta" allocates nothing: structure templates only
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
