"""Explicit device selection and the float32 precision contract.

The port never picks a device on its own: a session names ``"cuda"`` (the
H100) or, when the caller asks for it, ``"cpu"``.  Asking for CUDA on a
machine without a GPU raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_precision"]


def resolve_device(device):
    """``torch.device`` for an explicit ``"cuda"``/``"cuda:N"``/``"cpu"``."""
    if device is None:
        raise ValueError("a device is required: 'cuda' or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' explicitly to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def set_precision():
    """Full float32 matrix products and convolutions.

    Matches the JAX package's default ``Precision.HIGHEST``: TF32 keeps
    about three decimal digits, and cuDNN enables it by default.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
