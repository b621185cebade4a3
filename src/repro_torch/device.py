"""Which device the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Without a visible card that raises:
    the port never carries on silently on the CPU. The CPU runs only when the
    caller asks for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    return dev


def _index(dev: torch.device) -> int:
    if dev.type != "cuda":
        return 0
    return dev.index if dev.index is not None else torch.cuda.current_device()


def check_encoder_device(encoder, device: torch.device, owner: str) -> None:
    """Refuse an ``encoder`` whose tensors live on another device than the
    memory ``owner`` that shares it. An encoder without a ``device``
    attribute computes on the host and fits any device."""
    enc = getattr(encoder, "device", None)
    if enc is None:
        return
    enc = torch.device(enc)
    if enc.type != device.type or _index(enc) != _index(device):
        raise ValueError(f"{owner} runs on {device}, but its encoder runs on "
                         f"{enc}: build the encoder on the same device")
