"""Advisory cross-process lock for the device (the JAX package's
device_lock.py).

A long-lived engine owns most of the card's memory for the life of its
process. Every entry point that allocates one (the HTTP daemon) takes this
flock-based lock first and holds it until the process exits (flock
releases on exit, crashes included), so a second engine-owning process
waits instead of allocating into the same memory.

Runs on the CPU (QWEN3_TTS_CPU=1, the caller asked for the CPU) skip the
lock: there is no shared device to protect.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

LOCK_PATH = os.path.join(tempfile.gettempdir(), "qwen3_tts_device.lock")
_HELD = []  # keep fd objects alive for the process lifetime


def device_lock(
    *, wait_s: float | None = None, label: str = "", path: str = LOCK_PATH
) -> bool:
    """Acquire the device lock, waiting up to ``wait_s`` seconds.

    Returns True once held (kept until process exit), False on timeout.
    Default wait is QWEN3_TTS_DEVICE_LOCK_WAIT_S (3600 s). Set
    QWEN3_TTS_DEVICE_LOCK=0 to disable entirely.
    """
    if os.environ.get("QWEN3_TTS_DEVICE_LOCK", "1") in ("0", ""):
        return True
    if os.environ.get("QWEN3_TTS_CPU", "0") not in ("", "0"):
        return True
    try:
        import fcntl
    except ImportError:  # non-posix: nothing to do
        return True
    if wait_s is None:
        wait_s = float(os.environ.get("QWEN3_TTS_DEVICE_LOCK_WAIT_S", 3600))
    fh = open(path, "a+")
    deadline = time.time() + wait_s
    warned = False
    while True:
        try:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            _HELD.append(fh)
            if warned:
                print(f"[device lock acquired{' for ' + label if label else ''}]",
                      file=sys.stderr, flush=True)
            return True
        except OSError:
            if time.time() >= deadline:
                fh.close()
                return False
            if not warned:
                print(
                    f"[device busy (another process holds {path}); "
                    f"waiting up to {wait_s:.0f}s"
                    f"{' for ' + label if label else ''}]",
                    file=sys.stderr, flush=True,
                )
                warned = True
            time.sleep(max(0.1, min(10.0, deadline - time.time())))


def require_device_lock(label: str, *, wait_s: float | None = None,
                        path: str = LOCK_PATH) -> None:
    """Acquire the device lock or exit with code 3: the gate of measurement
    harnesses. Call after argument parsing and after any decision to run
    on the CPU, so ``--help`` and CPU runs never contend."""
    if not device_lock(wait_s=wait_s, label=label, path=path):
        print(f"{label}: device lock never freed; aborting",
              file=sys.stderr)
        raise SystemExit(3)
