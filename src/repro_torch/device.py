"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  When CUDA is
asked for and there is none, they raise: they never carry on silently on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but CUDA is not available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
