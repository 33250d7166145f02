"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Nothing is built
when this module is imported: a kernel builds at its first launch (or all
at once through :func:`build_all`, one ``nvcc`` per source, started
together) into ``build/kernels/`` at the repository root. Library names
carry a hash of the source, of the headers it includes and of the flags,
so an edited source or header rebuilds and an unchanged one loads.

The two matmul kernels (A and B: ``GROUPED_QMV``, ``DEQUANT_MATMUL``)
export two C entry points each, one per activation type (bfloat16 and
float32, e.g. ``qmv_grouped_bf16`` and ``qmv_grouped_f32``), both with the
signature::

    int fn(const void* x, const void* w, const void* scale, const void* bias,
           void* out, void* workspace, void* counters, int M, int K, int N,
           int gs, int plan0, int plan1, int plan2, int plan3, void* stream)

with the split-K workspace, the tile counters and four ints of the host's
launch plan: kernel A's (band_rows, bands, k_splits, sb_groups) from
``ops/grouped_qmv.py::plan_kernel_a``, kernel B's (m_frags, or the float32
ring's rows, k_splits, k_unit, sb_groups) from
``ops/dequant_matmul.py::plan_kernel_b`` (see each source's entry points:
both instances of a kernel read a plan). Each returns the CUDA error of its
launch; :class:`Kernel` raises when that is not 0, and counts the launches
that succeeded (per entry in ``by_dtype``, their sum in ``launches``) and the (M, N,
K, gs) shapes they ran. Kernel C (``DECODE_ATTENTION``,
``csrc/decode_attention.cu``, bound by ``ops/decode_attention.py``) has one
bf16 entry, counts the shapes named by its ``dims``, and exports one more C
function, ``decode_attention_fits`` (:meth:`Kernel.function`). Every kernel
also counts the calls of its kind that its caller sent to the plain code
instead (``declined``). The nvcc output of a build (ptxas' registers and
spills) is kept beside its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from collections.abc import Callable
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
    """One CUDA source, its shared library, its entry points by activation
    type (``symbols``: dtype name -> C symbol) and its launch counts: each
    entry's (``by_dtype``), their sum (``launches``), and the calls its
    caller found to be of the kernel's kind yet could not give it
    (``declined``)."""

    def __init__(self, name: str, source: str, symbols: dict[str, str],
                 argtypes, dims: tuple[str, ...] = ("M", "N", "K", "gs")):
        self.name = name
        self.source = CSRC / source
        self.symbols = symbols
        self.argtypes = argtypes
        self.dims = dims  # the names of a launch shape's entries
        self.by_dtype = dict.fromkeys(symbols, 0)
        self.shapes: set[tuple[int, ...]] = set()  # e.g. (M, N, K, gs)
        self.declined = 0
        self.build_log = ""
        self._handle = None
        self._fns = None

    def headers(self) -> list[Path]:
        """The headers the source includes with ``#include "..."``, found
        beside it as nvcc finds them."""
        names = re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                           self.source.read_text(), flags=re.M)
        return [self.source.parent / name for name in names]

    @property
    def launches(self) -> int:
        """Launches of all entry points since the last reset."""
        return sum(self.by_dtype.values())

    def library_path(self) -> Path:
        text = b"".join(p.read_bytes() for p in [self.source, *self.headers()])
        digest = hashlib.sha1(
            text + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def load(self) -> dict:
        """The bound C functions by dtype name; builds the library first if
        it is not in ``build/kernels/`` yet."""
        if self._fns is None:
            lib = self.library_path()
            if lib.exists():
                log = lib.with_suffix(".log")
                self.build_log = log.read_text() if log.exists() else ""
            else:
                self._build(lib)
            self._handle = ctypes.CDLL(str(lib))
            fns = {}
            for dtype, symbol in self.symbols.items():
                fn = getattr(self._handle, symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                fns[dtype] = fn
            self._fns = fns
        return self._fns

    def function(self, symbol: str, argtypes) -> Callable[..., int]:
        """Another C function of the library, returning an int (not an
        entry point: its calls are not counted)."""
        self.load()
        fn = getattr(self._handle, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

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
        lib.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, lib)

    def call(self, dtype: str, args: tuple, shape: tuple[int, ...]) -> None:
        """Call the ``dtype`` entry point with ``args`` (one launch of
        ``shape``, named by ``dims``); raises if the launch was refused."""
        rc = self.load()[dtype](*args)
        if rc != 0:
            named = ", ".join(f"{d}={v}" for d, v in zip(self.dims, shape))
            raise RuntimeError(
                f"CUDA kernel {self.name} ({dtype}) failed to launch: "
                f"cudaError {rc} ({named})"
            )
        self.by_dtype[dtype] += 1
        self.shapes.add(shape)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# x, w, scale, bias, out, workspace, counters; M, K, N, gs and four ints of
# the plan; stream
_ARGTYPES = [_PTR] * 7 + [_INT] * 8 + [_PTR]
# plan ints: band_rows, bands, k_splits, sb_groups
GROUPED_QMV = Kernel("grouped_qmv", "grouped_qmv.cu",
                     {"bfloat16": "qmv_grouped_bf16",
                      "float32": "qmv_grouped_f32"}, _ARGTYPES)
# plan ints: m_frags, k_splits, k_unit, sb_groups
DEQUANT_MATMUL = Kernel("dequant_matmul", "dequant_matmul.cu",
                        {"bfloat16": "dequant_matmul_bf16",
                         "float32": "dequant_matmul_f32"}, _ARGTYPES)
# q, k, v, q_norm, k_norm, cos, sin, cache_k, cache_v, pos, pad, win, out;
# the q, k, v token strides and the cache row stride; rope_stride, B, T,
# n_heads, n_kv_heads, S, pos_int, pad_int, max_win; eps, scale; stream
DECODE_ATTENTION = Kernel(
    "decode_attention", "decode_attention.cu",
    {"bfloat16": "decode_attention_bf16"},
    [_PTR] * 13 + [ctypes.c_longlong] * 4 + [_INT] * 9
    + [ctypes.c_float] * 2 + [_PTR],
    dims=("B", "T", "heads", "kv_heads", "window", "qk_norm", "row_pos",
          "split"))
KERNELS = (GROUPED_QMV, DEQUANT_MATMUL, DECODE_ATTENTION)


def build_all() -> None:
    """Build and load every kernel library, one nvcc per source, all
    started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(Kernel.load, KERNELS))


def reset_launch_counts() -> None:
    """Zero every kernel's launch and decline counts and forget the shapes
    it ran."""
    for k in KERNELS:
        k.by_dtype = dict.fromkeys(k.symbols, 0)
        k.shapes.clear()
        k.declined = 0
