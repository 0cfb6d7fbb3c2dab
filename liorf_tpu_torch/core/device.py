"""The one rule for where the port's state lives.

Every entry point that creates tensors takes ``device``. ``None`` means the
GPU (``cuda``) and raises when there is none: nothing runs on the CPU unless
the caller names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
