"""Device resolution shared by every entry point of the port.

`device=None` means the CUDA device: the port is written for the card and
never carries on quietly on the CPU. Callers that want the CPU (the parity
tests) ask for it explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
