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
with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` beside this
package (a library named by the source's digest) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "merged_min.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else /usr/local/cuda's."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _lib_path() -> str:
    # Keyed by the source's digest, so an edited source is rebuilt.
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libmerged_min-{digest}.so")


def start_build(extra_flags: Tuple[str, ...] = ()) -> Callable[[], str]:
    """Start ``nvcc`` on ``csrc/merged_min.cu`` and return a function that
    waits for it: it returns the compiler's diagnostics (with
    ``extra_flags=("-Xptxas", "-v")`` the register and shared-memory report)
    and raises ``RuntimeError`` if the build failed. Several sources can
    build at once this way."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib = _lib_path()
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *_NVCC_FLAGS, *extra_flags, "-o", tmp, _SOURCE],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )

    def wait() -> str:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SOURCE}:\n{err}")
        os.replace(tmp, lib)
        return out + err

    return wait


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                start_build()()
            lib = ctypes.CDLL(path)
            lib.merged_min_sums_launch.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.merged_min_sums_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


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
    lib = _load()
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.merged_min_sums_launch(
            *(x.data_ptr() for x in args),
            row.data_ptr(),
            col.data_ptr(),
            s,
            a,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"merged_min_sums kernel launch failed: CUDA error {err}")
    merged_min_sums.launches += 1
    return row, col


merged_min_sums.launches = 0
