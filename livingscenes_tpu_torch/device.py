"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device.

    With no device given and no CUDA device present this raises: an entry
    point never drops to the CPU quietly. Pass `device="cpu"` to run there.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
