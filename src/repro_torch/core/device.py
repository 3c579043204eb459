"""Device choice for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device and raises when CUDA is
    absent — the port never carries on on the CPU unless the caller passes
    ``device="cpu"`` (as the CPU tests do).  A CUDA device without an
    index means the current one, so engines compare equal to the devices
    of the tensors they hold."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
