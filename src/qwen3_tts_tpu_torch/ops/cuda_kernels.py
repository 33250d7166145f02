"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Nothing is built
when this module is imported: a kernel builds at its first launch (or all
at once through :func:`build_all`, one ``nvcc`` per source, started
together) into ``build/kernels/`` at the repository root. Library names
carry a hash of the source and the flags, so an edited source rebuilds and
an unchanged one loads.

Every C entry point has one signature::

    int fn(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int M, int K, int N, int gs, void* stream)

and returns ``cudaGetLastError()`` after its launch; :class:`Kernel` raises
when that is not 0, and counts the launches that succeeded and the
(M, N, K, gs) shapes they ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            f"source in {CSRC}"
        )
    return found


class Kernel:
    """One CUDA source, its shared library and its launch count."""

    def __init__(self, name: str, source: str, symbol: str):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.launches = 0
        self.shapes: set[tuple[int, int, int, int]] = set()  # (M, N, K, gs)
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        digest = hashlib.sha1(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def load(self):
        """The bound C function; builds the library first if it is not in
        ``build/kernels/`` yet."""
        if self._fn is None:
            lib = self.library_path()
            if not lib.exists():
                self._build(lib)
            fn = getattr(ctypes.CDLL(str(lib)), self.symbol)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _build(self, lib: Path) -> None:
        """nvcc into a temporary name, then move into place atomically
        (concurrent processes may build the same library)."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self.build_log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{proc.stdout}"
            )
        os.replace(tmp, lib)

    def launch(self, x, w, scale, bias, out, M: int, K: int, N: int, gs: int,
               stream: int) -> None:
        """Launch on ``stream`` (a ``cudaStream_t`` as int); raises if the
        launch was refused. Pointers are ``tensor.data_ptr()`` ints."""
        rc = self.load()(x, w, scale, bias, out, M, K, N, gs, stream)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {rc} "
                f"(M={M}, K={K}, N={N}, gs={gs})"
            )
        self.launches += 1
        self.shapes.add((M, N, K, gs))


GROUPED_QMV = Kernel("grouped_qmv", "grouped_qmv.cu", "qmv_grouped_bf16")
DEQUANT_MATMUL = Kernel(
    "dequant_matmul", "dequant_matmul.cu", "dequant_matmul_bf16"
)
KERNELS = (GROUPED_QMV, DEQUANT_MATMUL)


def build_all() -> None:
    """Build and load every kernel library, one nvcc per source, all
    started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(Kernel.load, KERNELS))


def reset_launch_counts() -> None:
    """Zero every kernel's launch count and forget the shapes it ran."""
    for k in KERNELS:
        k.launches = 0
        k.shapes.clear()
