"""Device selection (counterpart of the reference's ``jaxenv.py``).

The port runs on the first CUDA card.  The CPU is used only when the
caller names it (``device="cpu"``, as the tests do): a machine without
CUDA raises instead of carrying on with the plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
