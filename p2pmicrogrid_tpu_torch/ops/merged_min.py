"""The factored market's merged min pass (kernel K1) and its plain version.

For each scenario s, with inputs ``[S, A]`` float32 (masks as 0/1 floats)::

    m[i, j] = min(alpha_i * (prop_b_i ? wplus_j : 1),
                  (prop_s_j ? wminus_i : 1) * gamma_j)
    row_i = sum_j m[i, j];   col_j = sum_i m[i, j]

never building the ``[A, A]`` matrix. It replaces the JAX package's Pallas
TPU kernel ``ops/pallas_factored.py::merged_min_sums_pallas`` (the merged pass
of ``ops/factored_market.py::clear_factored_rounds1``).

``merged_min_sums`` launches the CUDA kernel (``csrc/merged_min.cu``) for
tensors on a CUDA device and runs ``merged_min_sums_plain`` for tensors on
the CPU; there is no fallback from one to the other. The kernel is built
at first use (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.ops._build import KernelLibrary, launch


def _configure(lib: ctypes.CDLL) -> None:
    lib.merged_min_sums_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.merged_min_sums_launch.restype = ctypes.c_int


LIBRARY = KernelLibrary("merged_min.cu", _configure)


def merged_min_sums_plain(
    alpha: torch.Tensor,
    wplus: torch.Tensor,
    wminus: torch.Tensor,
    gamma: torch.Tensor,
    prop_b: torch.Tensor,
    prop_s: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast min + sums in plain torch (materialises ``[..., A, A]``)."""
    lhs = torch.where(
        prop_b[..., :, None] > 0.0,
        alpha[..., :, None] * wplus[..., None, :],
        alpha[..., :, None],
    )
    rhs = torch.where(
        prop_s[..., None, :] > 0.0,
        wminus[..., :, None] * gamma[..., None, :],
        gamma[..., None, :],
    )
    m = torch.minimum(lhs, rhs)
    return m.sum(dim=-1), m.sum(dim=-2)


def _check(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device != like.device or x.dtype != torch.float32:
        raise ValueError(
            f"merged_min_sums: {name} must be float32 on {like.device}, got "
            f"{x.dtype} on {x.device}"
        )
    if x.shape != like.shape or x.dim() != 2:
        raise ValueError(
            f"merged_min_sums: {name} must have shape [S, A] = "
            f"{tuple(like.shape)}, got {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"merged_min_sums: {name} must be contiguous")


def merged_min_sums(
    alpha: torch.Tensor,
    wplus: torch.Tensor,
    wminus: torch.Tensor,
    gamma: torch.Tensor,
    prop_b: torch.Tensor,
    prop_s: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, col) sums of the merged min matrix, each ``[S, A]`` float32.

    CUDA tensors launch the kernel on the current stream (counted in
    ``merged_min_sums.launches``); CPU tensors take the plain version.
    """
    if alpha.device.type != "cuda":
        return merged_min_sums_plain(alpha, wplus, wminus, gamma, prop_b, prop_s)
    args = (alpha, wplus, wminus, gamma, prop_b, prop_s)
    for name, x in zip(("alpha", "wplus", "wminus", "gamma", "prop_b", "prop_s"), args):
        _check(name, x, alpha)
    s, a = alpha.shape
    row = torch.empty_like(alpha)
    col = torch.empty_like(alpha)
    launch(
        "merged_min_sums", alpha.device, LIBRARY.load().merged_min_sums_launch,
        *(x.data_ptr() for x in args), row.data_ptr(), col.data_ptr(), s, a,
    )
    merged_min_sums.launches += 1
    return row, col


merged_min_sums.launches = 0
