"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without CUDA that raises: the CPU is used
    only when the caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given; the port "
                "runs on the GPU by default, pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
