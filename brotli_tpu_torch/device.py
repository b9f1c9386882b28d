"""Device selection: the port runs where its caller says, never elsewhere."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device.

    Raises on "cuda" when this PyTorch sees no card, so a request for the
    GPU never quietly runs on the CPU.  CPU tensors take the plain PyTorch
    versions of the kernels; CUDA tensors take the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested, but torch.cuda.is_available() "
                "is False on this machine"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cpu' or 'cuda'")
    return dev
