"""Device choice for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_numpy"]


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` means the current CUDA device and raises when
    CUDA is absent — the port never carries on on the CPU unless the caller
    passes ``device="cpu"`` (as the CPU tests do).  A CUDA device without an
    index means the current one, so engines compare equal to the devices
    of the tensors they hold."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def as_numpy(x) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a numpy array
    (the host builders take either)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
