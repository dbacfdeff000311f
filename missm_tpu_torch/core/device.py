"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device. The port runs on the card unless the
    caller asks for the CPU: a CUDA device with no GPU present raises
    instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
