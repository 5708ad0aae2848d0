"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  When CUDA is
asked for and there is none, they raise: they never carry on silently on
the CPU.  A rank of a sharded solve runs on ``cuda:<local rank>``
(:func:`rank_device`).
"""
from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but CUDA is not available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev


def rank_device(device="cuda", local_rank: int | None = None) -> torch.device:
    """The device of this process's rank: the CPU when ``device`` says so,
    else ``cuda:<local rank>`` (``local_rank``, or the ``LOCAL_RANK`` that
    torchrun sets, or 0), which must exist."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no card: {torch.cuda.device_count()}"
            " visible (one process per GPU)")
    return torch.device("cuda", local_rank)
