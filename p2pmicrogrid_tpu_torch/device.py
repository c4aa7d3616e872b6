"""Device selection for the port's entry points.

Every entry point defaults to ``device="cuda"``. It runs on the CPU only when
the caller asks for it with ``device="cpu"`` (the tests do); a CUDA request on
a machine without a usable card raises instead of carrying on on the CPU.
``device="auto"`` (the JAX package's crossover placement, measured on a TPU
host) raises until a crossover measured on the card exists.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and there is none
    and for ``"auto"``."""
    if isinstance(device, str) and device == "auto":
        raise ValueError(
            "device='auto' (crossover placement) waits for a crossover "
            "measured on the card (ROADMAP.md, Queue 1, item 8); pass "
            "device='cuda' or device='cpu'"
        )
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "p2pmicrogrid_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "on the CPU"
        )
    return dev
