"""Device selection shared by the port's entry points.

``None`` means the CUDA device. Without CUDA an entry point raises unless
the caller asked for the CPU explicitly: the port never runs on the CPU
silently."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Turn an entry point's ``device=`` argument into a ``torch.device``
    and switch TF32 off, since the port computes in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        dev = torch.device("cuda")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            # the form tensors report, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
