"""The port's device policy: ``None`` is the card, and nothing falls back
to the host on its own."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` → ``cuda``.  A CUDA device where CUDA is missing raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the host")
    return dev
