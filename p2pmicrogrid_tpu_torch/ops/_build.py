"""Build a CUDA source of the port with ``nvcc`` and load it with ``ctypes``.

Each source in ``csrc/`` is compiled for ``sm_90a`` into a shared library
with a plain C interface, under ``_build/`` beside this package, named by the
digest of the source and of the ``csrc/`` headers it includes (an edited
source or header is rebuilt), and loaded with ``ctypes``.
Nothing is built when a module is imported: a wrapper loads its library at
its first launch on a CUDA tensor, and a build failure raises, as does a
launch that returns a CUDA error (``launch``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# No --use_fast_math: the kernels divide and round as IEEE float32 does, like
# their plain versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_closure(source: str) -> Tuple[str, ...]:
    """``source`` and every header it includes with ``#include "..."``,
    transitively, resolved beside the including file; sorted after the
    source, so the order is stable."""
    seen, todo = set(), [os.path.abspath(source)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        base = os.path.dirname(path)
        todo.extend(os.path.join(base, m.decode()) for m in _INCLUDE.findall(text))
    first = os.path.abspath(source)
    return (first,) + tuple(sorted(seen - {first}))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else /usr/local/cuda's."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


class KernelLibrary:
    """One ``csrc/`` source, built at first use and loaded once.

    ``configure(lib)`` declares the C functions' ``argtypes``/``restype`` on
    the loaded ``ctypes.CDLL``.
    """

    def __init__(self, source_name: str, configure: Callable[[ctypes.CDLL], None]):
        self.name = os.path.splitext(source_name)[0]
        self.source = os.path.join(_PKG_DIR, "csrc", source_name)
        self._configure = configure
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> str:
        h = hashlib.sha256()
        for part in source_closure(self.source):
            with open(part, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"lib{self.name}-{digest}.so")

    def start_build(self, extra_flags: Tuple[str, ...] = ()) -> Callable[[], str]:
        """Start ``nvcc`` on the source and return a function that waits for
        it: it returns the compiler's diagnostics (with
        ``extra_flags=("-Xptxas", "-v")`` the register and shared-memory
        report) and raises ``RuntimeError`` if the build failed. Several
        sources can build at once this way."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib = self.path()
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp, self.source],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )

        def wait() -> str:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source}:\n{err}")
            os.replace(tmp, lib)
            return out + err

        return wait

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if its digest has no build yet."""
        with self._lock:
            if self._lib is None:
                path = self.path()
                if not os.path.exists(path):
                    self.start_build()()
                lib = ctypes.CDLL(path)
                self._configure(lib)
                self._lib = lib
        return self._lib


def launch(what: str, device: torch.device, c_fn, *args) -> None:
    """Call the C entry point ``c_fn(*args, stream)`` on ``device``'s current
    stream. It launches without synchronising and returns
    ``cudaGetLastError()``; a non-zero code raises ``RuntimeError``."""
    with torch.cuda.device(device):
        err = c_fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# Launches recorded into a CUDA graph by the capture under way
# (``parallel/graph.py::capture``), by wrapper; None outside a capture.
_capture_tally: Optional[Dict[Callable, int]] = None


def count_launch(wrapper: Callable) -> None:
    """Add one to ``wrapper.launches`` where the wrapper launches its kernel
    on the card. Under CUDA graph capture the kernel is recorded, not run:
    the capture tallies it, and each replay of the graph adds the tally
    (``parallel/graph.py``). A capture that ``parallel/graph.py`` did not
    start raises."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
        return
    if _capture_tally is None:
        raise RuntimeError(
            f"{wrapper.__name__}: a kernel launch under a CUDA graph capture that "
            "parallel/graph.py::capture did not start would go uncounted"
        )
    _capture_tally[wrapper] = _capture_tally.get(wrapper, 0) + 1


def kernel_wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of the port, by name (K1, K2-K6, K7)."""
    from p2pmicrogrid_tpu_torch.ops import matrix_market as mm
    from p2pmicrogrid_tpu_torch.ops.merged_min import merged_min_sums
    from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused

    wrappers = (
        merged_min_sums, mm.divide_rank1_fused, mm.divide_power_fused_with_mean,
        mm.clear_market_fused, mm.divide_power_fused, mm.prep_mean, slot_step_fused,
    )
    return {w.__name__: w for w in wrappers}


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far, by name."""
    return {name: w.launches for name, w in kernel_wrappers().items()}
