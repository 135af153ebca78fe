"""Device resolution for the port's entry points: the card unless the
caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None means the CUDA card; a CUDA device without a card raises (the
    port never carries on on the CPU unless asked to)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run the "
            "plain PyTorch version on the CPU"
        )
    return dev
