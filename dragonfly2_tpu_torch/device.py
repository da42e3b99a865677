"""Device resolution for the port's entry points.

Entry points run on the CUDA device by default. The CPU is used only when
the caller asks for it (``device="cpu"``, as the tests do); a run that
wants CUDA on a machine without it raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the default CUDA device. A CUDA device that is not
    available raises RuntimeError; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
