"""Float32 constants as the reference computes them.

The JAX reference runs jitted, and XLA rewrites ``x / c`` for a constant ``c``
into ``x * (1 / c)`` with the reciprocal rounded to float32; PyTorch on CUDA
does the same for a Python scalar divisor. Writing every division by a
constant as a multiplication by ``recip(c)`` gives the same rounding on the
CPU and on the card, so a discrete bin computed from the result agrees.
"""

from __future__ import annotations

import numpy as np


def recip(x: float) -> float:
    """float32 ``1 / x`` with both operands in float32."""
    return float(np.float32(1.0) / np.float32(x))


def sqrt(x: float) -> float:
    """float32 square root of the float32 constant ``x`` (``jnp.sqrt`` of a
    Python float)."""
    return float(np.sqrt(np.float32(x)))
