"""Build the native audio library at first use.

One g++ invocation for one translation unit with no dependencies: the
compiler is ``$CXX``, else ``g++``, else ``clang++``. The library goes to
``build/native/`` at the repository root (beside the CUDA kernels'
``build/kernels/``), named by a hash of the source, so an edited source
rebuilds and an unchanged one loads. The compiler's output is kept beside
the library as ``.log``; a compile that fails raises with it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "audio_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libq3tts_audio_{digest}.so"


def compiler() -> str | None:
    """``$CXX``, g++ or clang++; None when the host has none."""
    return (os.environ.get("CXX") or shutil.which("g++")
            or shutil.which("clang++"))


def ensure_built() -> Path | None:
    """The library's path, compiled first if it is not built yet; None
    when no compiler exists. Raises with the compiler's output when the
    compile fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # pid-unique temp name, then an atomic rename: processes that build at
    # once never write into one file, and each ends with a whole library
    tmp = lib.with_name(f".{lib.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{cxx} could not build {SRC}: {e}") from e
    lib.with_suffix(".log").write_text(proc.stdout)
    try:
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed for {SRC} (exit {proc.returncode}):\n"
                f"{proc.stdout}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib
