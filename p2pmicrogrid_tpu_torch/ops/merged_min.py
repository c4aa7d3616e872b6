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
at first use (``ops/_build.py``). It computes each entry once: a block owns
64 rows of one scenario and walks every column, so the row sums are whole
and the column sums come as one partial per tile of rows, added in order
by a second small kernel (not launched where one tile covers A <= 64).
``kernel_config`` reports the launch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.ops._build import KernelLibrary, count_launch, launch


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.merged_min_sums_launch.argtypes = [p] * 9 + [i, i, p]
    lib.merged_min_config.argtypes = [i, i, p]
    for fn in (lib.merged_min_sums_launch, lib.merged_min_config):
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("merged_min.cu", _configure)
_TILE_ROWS = 64  # rows i of a block (kTileRows in csrc/merged_min.cu)


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
    lib = LIBRARY.load()
    row = torch.empty_like(alpha)
    col = torch.empty_like(alpha)
    tiles = -(-a // _TILE_ROWS)
    # Each tile of rows' column sums, added in order by the second kernel.
    partial = (
        torch.empty((s, tiles, a), dtype=torch.float32, device=alpha.device) if tiles > 1 else None
    )
    launch(
        "merged_min_sums", alpha.device, lib.merged_min_sums_launch,
        *(x.data_ptr() for x in args), row.data_ptr(), col.data_ptr(),
        None if partial is None else partial.data_ptr(), s, a,
    )
    count_launch(merged_min_sums)
    return row, col


merged_min_sums.launches = 0


def kernel_config(s: int, a: int, device) -> dict:
    """How ``merged_min_sums`` launches at [s, a] on ``device``: the design,
    grid, threads a block, shared memory a block (bytes), columns a thread
    takes a step, steps a block, and whether the column sums' second kernel
    runs."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = LIBRARY.load().merged_min_config(s, a, out)
    if err != 0:
        raise RuntimeError(f"merged_min kernel_config: CUDA error {err}")
    return dict(
        design="each entry once: 64-row tiles walk every column, column partials added in order",
        grid=[out[0], out[1]], threads=out[2], smem_bytes=out[3], cols_per_thread=out[4],
        steps=out[5], colsum_kernel=out[0] > 1,
    )
