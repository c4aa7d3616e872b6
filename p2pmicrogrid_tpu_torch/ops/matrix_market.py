"""The matrix negotiation's fused passes (kernels K2-K6) and their plain
versions.

The counterpart of the JAX package's ``ops/pallas_market.py``, with its
names, signatures and dtypes. Per scenario, on ``[S, A, A]`` proposal
matrices (float32 or bfloat16 storage; all arithmetic float32):

* ``prep_mean(p2p)`` (K2): ``-sum_{j != i} p2p[:, j, i] / A``, the mean-p2p
  observation, ``[S, A]`` float32.
* ``divide_power_fused(p2p, out_power)`` (K3): the proposal split
  (``ops/market.py::divide_power``) against ``powers = -p2p^T`` with the
  diagonal zeroed, in p2p's dtype.
* ``divide_power_fused_with_mean(p2p, out_power)`` (K4): K3 and K2 of its
  own float32 output, before that output is rounded to p2p's dtype.
* ``divide_rank1_fused(prev_out, out_power, out_dtype)`` (K5): K4 against the
  rank-1 matrix ``prev_out[i] / A`` (round 0's output), never built.
* ``clear_market_fused(p2p)`` (K6): sign-opposition matching
  (``ops/market.py::clear_market``), ``(p_grid, p_p2p)`` float32.

Each wrapper launches its CUDA kernel (``csrc/matrix_market.cu``) for tensors
on a CUDA device, counted in ``<wrapper>.launches``, and runs its ``*_plain``
version for tensors on the CPU; there is no fallback from one to the other,
and a failed build or launch raises. The plain versions reuse the semantic
oracle of ``ops/market.py`` and round to bfloat16 at the same points as the
kernels.

K4 holds a stripe of ``stripe_rows`` rows in shared memory; where not even 8
rows fit (on an H100, A above 14,336 in bfloat16 or 7,168 in float32), it
runs the two-pass kernel that K3 shares. K5 holds its vector of A powers in
shared memory and takes stripes of ``rank1_rows`` rows; where the vector does
not fit (on an H100, A above 52,736), it runs the two-pass kernel. Those
choices are rules on the shape, never reactions to a failure.
``kernel_config`` reports each launch's grid.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.ops._build import KernelLibrary, count_launch, launch
from p2pmicrogrid_tpu_torch.ops._f32 import recip
from p2pmicrogrid_tpu_torch.ops.market import clear_market, divide_power

_MATRIX_DTYPES = (torch.float32, torch.bfloat16)


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.divide_rank1_launch.argtypes = [p] * 5 + [i, i, i, p]
    lib.divide_rank1_stripe_launch.argtypes = [p] * 5 + [i, i, i, i, p]
    lib.divide_power_launch.argtypes = [p] * 5 + [i, i, i, i, p]
    lib.prep_mean_launch.argtypes = [p, p, i, i, i, p]
    lib.divide_mean_stripe_launch.argtypes = [p] * 5 + [i, i, i, i, p]
    lib.clear_market_launch.argtypes = [p] * 4 + [i, i, i, p]
    lib.matrix_market_stripe_rows.argtypes = []
    lib.matrix_market_smem_limits.argtypes = [p]
    lib.matrix_kernel_config.argtypes = [i] * 5 + [p]
    for fn in (
        lib.divide_rank1_launch,
        lib.divide_rank1_stripe_launch,
        lib.divide_power_launch,
        lib.divide_mean_stripe_launch,
        lib.prep_mean_launch,
        lib.clear_market_launch,
        lib.matrix_market_stripe_rows,
        lib.matrix_market_smem_limits,
        lib.matrix_kernel_config,
    ):
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("matrix_market.cu", _configure)


# --- plain versions ----------------------------------------------------------


def _off_diagonal(a: int, device) -> torch.Tensor:
    return 1.0 - torch.eye(a, dtype=torch.float32, device=device)


def _column_mean(new: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``-sum_{i != j} new[:, i, j] / A``, [S, A]."""
    return -(new * mask).sum(dim=-2) * recip(new.shape[-1])


def _split(p2p: torch.Tensor, out_power: torch.Tensor):
    mask = _off_diagonal(p2p.shape[-1], p2p.device)
    powers = -(p2p.float() * mask).transpose(-1, -2)
    return divide_power(out_power, powers), mask


def prep_mean_plain(p2p: torch.Tensor) -> torch.Tensor:
    return _column_mean(p2p.float(), _off_diagonal(p2p.shape[-1], p2p.device))


def divide_power_fused_plain(p2p: torch.Tensor, out_power: torch.Tensor) -> torch.Tensor:
    return _split(p2p, out_power)[0].to(p2p.dtype)


def divide_power_fused_with_mean_plain(
    p2p: torch.Tensor, out_power: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    new, mask = _split(p2p, out_power)
    return new.to(p2p.dtype), _column_mean(new, mask)


def divide_rank1_fused_plain(
    prev_out: torch.Tensor, out_power: torch.Tensor, out_dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    a = prev_out.shape[-1]
    mask = _off_diagonal(a, prev_out.device)
    # powers[s, i, j] = -(prev[s, j] / A), indexed by j; 0 on the diagonal.
    powers = (-prev_out[:, None, :] * recip(a)) * mask
    new = divide_power(out_power, powers)
    return new.to(out_dtype), _column_mean(new, mask)


def clear_market_fused_plain(p2p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return clear_market(p2p.float())


# --- kernel wrappers ---------------------------------------------------------


def _check_vec(fn: str, name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(
            f"{fn}: {name} must be float32 on {device}, got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape [S, A] = {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_mat(fn: str, p2p: torch.Tensor) -> None:
    if p2p.dtype not in _MATRIX_DTYPES:
        raise ValueError(f"{fn}: p2p must be float32 or bfloat16, got {p2p.dtype}")
    if p2p.dim() != 3 or p2p.shape[1] != p2p.shape[2] or p2p.numel() == 0:
        raise ValueError(f"{fn}: p2p must have shape [S, A, A], got {tuple(p2p.shape)}")
    if not p2p.is_contiguous():
        raise ValueError(f"{fn}: p2p must be contiguous")


def _col_partial(s: int, a: int, rows: int, device) -> torch.Tensor:
    return torch.empty((s, -(-a // rows), a), dtype=torch.float32, device=device)


# Shared memory K4's block needs beside its stripe: its static arrays (1.5
# KB: a float4 and a float2 for each of 64 rows), the 1 KB the device
# reserves for each block, and 0.5 KB to spare.
_STRIPE_OVERHEAD_BYTES = 3072


_PAIR_TILE = 64  # K6: agents of a tile


def stripe_bytes(a: int, rows: int, elem_bytes: int) -> int:
    """Shared memory of K4's stripe: ``ceil(a / 32) * 32`` rows j of ``rows``
    entries."""
    return -(-a // 32) * 32 * rows * elem_bytes


def stripe_rows(a: int, elem_bytes: int, block_bytes: int, sm_bytes: int) -> int:
    """Rows i of K4's stripe in shared memory at ``a`` agents, or 0 when not
    even 8 fit in the ``block_bytes`` a block may hold: the two-pass kernel.

    The largest of 64, 32, 16, 8 rows (16 to 128 bytes a row) whose stripe
    lets three blocks share an SM's ``sm_bytes``, so that one block's loads
    overlap another's arithmetic and stores; else the largest that one block
    holds. At a = 1000: 32 rows in bfloat16, 16 in float32 (64 KB)."""
    choices = [r for r in (64, 32, 16, 8) if 16 <= r * elem_bytes <= 128]
    for blocks in (3, 1):
        for rows in choices:
            need = stripe_bytes(a, rows, elem_bytes) + _STRIPE_OVERHEAD_BYTES
            if need <= block_bytes and blocks * need <= sm_bytes:
                return rows
    return 0


# Shared memory K5's block needs beside its vector of powers: its static
# arrays (19,840 bytes: the column partials' two [8, 256] buffers, 128 rows'
# constants), the 1 KB the device reserves for each block, and 0.6 KB to
# spare.
_RANK1_OVERHEAD_BYTES = 21504


def rank1_fits(a: int, block_bytes: int) -> bool:
    """Whether K5's vector of powers at ``a`` agents (float32, padded to its
    256-column chunks) fits in the ``block_bytes`` a block may hold (on an
    H100, up to A = 52,736); else the two-pass kernel runs."""
    return -(-a // 256) * 256 * 4 + _RANK1_OVERHEAD_BYTES <= block_bytes


def rank1_rows(a: int) -> int:
    """Rows i of K5's stripes at ``a`` agents: one stripe a scenario up to A
    = 128, where a stripe's fixed cost (staging the powers, three barriers,
    the lane chains) outweighs its work; else 32 rows, 4 a warp, the two-pass
    kernel's tile height, so the column sums keep its order too. On an H100
    at [64, 1000] it was the fastest height tried, level with 40 rows; the
    stripes sized to fill the card once (112 rows) left a tail."""
    return -(-a // 8) * 8 if a <= 128 else 32


def _k5_rows(a: int, device: torch.device) -> int:
    """K5's stripe rows on ``device``, or 0: the two-pass kernel."""
    return rank1_rows(a) if rank1_fits(a, _smem_limits(device.index)[0]) else 0


@functools.lru_cache(maxsize=None)
def _smem_limits(device_index: int) -> Tuple[int, int]:
    """(shared memory a block may opt in to, an SM's) of a CUDA device."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        err = LIBRARY.load().matrix_market_smem_limits(out)
    if err != 0:
        raise RuntimeError(f"matrix_market_smem_limits: CUDA error {err}")
    return out[0], out[1]


def _k4_rows(a: int, dtype, device: torch.device) -> int:
    return stripe_rows(a, torch.finfo(dtype).bits // 8, *_smem_limits(device.index))


def kernel_config(name: str, s: int, a: int, dtype, device) -> dict:
    """How ``divide_rank1_fused`` (K5), ``divide_power_fused_with_mean`` (K4)
    or ``clear_market_fused`` (K6) launches at [s, a] in ``dtype`` on
    ``device``: the design, grid, threads a block, shared memory a block
    (bytes), the stripe's rows (K4, K5) and the global access width
    (bytes)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    bf16 = int(dtype == torch.bfloat16)
    if name == "divide_rank1_fused":
        rows = _k5_rows(a, device)
        if rows == 0:
            return dict(design="two-pass split_kernel (the vector does not fit in shared memory)",
                        rows=0)
        kernel, design = 5, "vector of powers in shared memory, the matrix written in one pass"
    elif name == "divide_power_fused_with_mean":
        rows = _k4_rows(a, dtype, device)
        if rows == 0:
            return dict(design="two-pass split_kernel (no 8-row stripe fits in shared memory)",
                        rows=0)
        kernel, design = 4, "stripe of rows i in shared memory, the matrix read once"
    elif name == "clear_market_fused":
        rows, kernel = 0, 6
        design = "each unordered pair of 64x64 tiles once, then the tile sums in order"
    else:
        raise ValueError(f"kernel_config: no configuration for {name}")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = LIBRARY.load().matrix_kernel_config(kernel, s, a, bf16, rows, out)
    if err != 0:
        raise RuntimeError(f"kernel_config({name}): CUDA error {err}")
    return dict(design=design, grid=[out[0], out[1]], threads=out[2], smem_bytes=out[3],
                rows=rows, vector_bytes=out[4])


def prep_mean(p2p: torch.Tensor) -> torch.Tensor:
    """[S, A, A] -> [S, A] float32 (K2)."""
    if p2p.device.type != "cuda":
        return prep_mean_plain(p2p)
    _check_mat("prep_mean", p2p)
    s, a, _ = p2p.shape
    mean = torch.empty((s, a), dtype=torch.float32, device=p2p.device)
    launch(
        "prep_mean", p2p.device, LIBRARY.load().prep_mean_launch, p2p.data_ptr(),
        mean.data_ptr(), s, a, int(p2p.dtype == torch.bfloat16),
    )
    count_launch(prep_mean)
    return mean


def _divide(fn: str, p2p: torch.Tensor, out_power: torch.Tensor, with_mean: bool):
    _check_mat(fn, p2p)
    s, a, _ = p2p.shape
    _check_vec(fn, "out_power", out_power, (s, a), p2p.device)
    new = torch.empty_like(p2p)
    lib = LIBRARY.load()
    mean = partial = None
    if with_mean:
        mean = torch.empty((s, a), dtype=torch.float32, device=p2p.device)
        rows = _k4_rows(a, p2p.dtype, p2p.device)
        if rows:
            partial = _col_partial(s, a, rows, p2p.device)
            launch(
                fn, p2p.device, lib.divide_mean_stripe_launch, p2p.data_ptr(),
                out_power.data_ptr(), new.data_ptr(), mean.data_ptr(), partial.data_ptr(),
                s, a, int(p2p.dtype == torch.bfloat16), rows,
            )
            return new, mean
        partial = _col_partial(s, a, lib.matrix_market_stripe_rows(), p2p.device)
    launch(
        fn, p2p.device, lib.divide_power_launch, p2p.data_ptr(), out_power.data_ptr(),
        new.data_ptr(), None if mean is None else mean.data_ptr(),
        None if partial is None else partial.data_ptr(), s, a,
        int(p2p.dtype == torch.bfloat16), int(with_mean),
    )
    return new, mean


def divide_power_fused(p2p: torch.Tensor, out_power: torch.Tensor) -> torch.Tensor:
    """[S, A, A], [S, A] -> [S, A, A] in p2p's dtype (K3)."""
    if p2p.device.type != "cuda":
        return divide_power_fused_plain(p2p, out_power)
    new, _ = _divide("divide_power_fused", p2p, out_power, with_mean=False)
    count_launch(divide_power_fused)
    return new


def divide_power_fused_with_mean(
    p2p: torch.Tensor, out_power: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, A, A], [S, A] -> (new p2p [S, A, A] in p2p's dtype, its prep_mean
    [S, A] float32 from the unrounded values) (K4)."""
    if p2p.device.type != "cuda":
        return divide_power_fused_with_mean_plain(p2p, out_power)
    out = _divide("divide_power_fused_with_mean", p2p, out_power, with_mean=True)
    count_launch(divide_power_fused_with_mean)
    return out


def divide_rank1_fused(
    prev_out: torch.Tensor, out_power: torch.Tensor, out_dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, A] round-0 powers, [S, A] -> (new p2p [S, A, A] in ``out_dtype``,
    its prep_mean [S, A] float32) (K5)."""
    if prev_out.device.type != "cuda":
        return divide_rank1_fused_plain(prev_out, out_power, out_dtype)
    fn = "divide_rank1_fused"
    if out_dtype not in _MATRIX_DTYPES:
        raise ValueError(f"{fn}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if prev_out.dim() != 2 or prev_out.numel() == 0:
        raise ValueError(f"{fn}: prev_out must have shape [S, A], got {tuple(prev_out.shape)}")
    s, a = prev_out.shape
    _check_vec(fn, "prev_out", prev_out, (s, a), prev_out.device)
    _check_vec(fn, "out_power", out_power, (s, a), prev_out.device)
    out = _divide_rank1(prev_out, out_power, out_dtype)
    count_launch(divide_rank1_fused)
    return out


def _divide_rank1(prev_out: torch.Tensor, out_power: torch.Tensor, out_dtype, two_pass=False):
    """K5's launch on checked inputs, by the shape rule (``_k5_rows``), or
    the two-pass kernel where ``two_pass`` is set (its card checks)."""
    s, a = prev_out.shape
    rows = 0 if two_pass else _k5_rows(a, prev_out.device)
    new = torch.empty((s, a, a), dtype=out_dtype, device=prev_out.device)
    mean = torch.empty((s, a), dtype=torch.float32, device=prev_out.device)
    lib = LIBRARY.load()
    bf16 = int(out_dtype == torch.bfloat16)
    if rows:
        partial = _col_partial(s, a, rows, prev_out.device)
        c_fn, extra = lib.divide_rank1_stripe_launch, (bf16, rows)
    else:
        partial = _col_partial(s, a, lib.matrix_market_stripe_rows(), prev_out.device)
        c_fn, extra = lib.divide_rank1_launch, (bf16,)
    launch(
        "divide_rank1_fused", prev_out.device, c_fn, prev_out.data_ptr(), out_power.data_ptr(),
        new.data_ptr(), mean.data_ptr(), partial.data_ptr(), s, a, *extra,
    )
    return new, mean


def clear_market_fused(p2p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, A, A] -> (p_grid [S, A], p_p2p [S, A]) float32 (K6)."""
    if p2p.device.type != "cuda":
        return clear_market_fused_plain(p2p)
    _check_mat("clear_market_fused", p2p)
    s, a, _ = p2p.shape
    grid = torch.empty((s, a), dtype=torch.float32, device=p2p.device)
    peer = torch.empty_like(grid)
    # Row sums over each tile of columns: grid's, then peer's.
    parts = torch.empty((2, s, -(-a // _PAIR_TILE), a), dtype=torch.float32, device=p2p.device)
    launch(
        "clear_market_fused", p2p.device, LIBRARY.load().clear_market_launch,
        p2p.data_ptr(), grid.data_ptr(), peer.data_ptr(), parts.data_ptr(), s, a,
        int(p2p.dtype == torch.bfloat16),
    )
    count_launch(clear_market_fused)
    return grid, peer


for _wrapper in (
    prep_mean,
    divide_power_fused,
    divide_power_fused_with_mean,
    divide_rank1_fused,
    clear_market_fused,
):
    _wrapper.launches = 0
