"""Interactive terminal app of the port (the JAX package's root app.py):

    PYTHONPATH=src python -m qwen3_tts_tpu_torch.app                    # the GPU
    QWEN3_TTS_CPU=1 PYTHONPATH=src python -m qwen3_tts_tpu_torch.app    # the CPU

An engine check (torch, and a CUDA device unless QWEN3_TTS_CPU=1; without
either it prints a panel and exits 1, where the JAX app falls back to the
CPU), the device lock, then a mode menu with model-presence dots in a loop
that survives a failed session. Needs ``rich`` and ``prompt_toolkit``.
"""

from __future__ import annotations

import os
import warnings

from . import config
from .io import get_smart_path
from .sessions import run_clone_manager, run_custom_session, run_design_session
from .ui import (
    BackSignal,
    clear_screen,
    console,
    instant_menu_choice,
    panel,
    print_banner,
)


def _cpu_forced() -> bool:
    return os.environ.get("QWEN3_TTS_CPU", "0") not in ("", "0")


def _engine_check() -> bool:
    """The engine needs torch, and a CUDA device unless QWEN3_TTS_CPU=1;
    otherwise a panel says why, and False."""
    try:
        import torch
    except ImportError as exc:
        reason = f"PyTorch could not be imported: {exc}"
    else:
        if _cpu_forced() or torch.cuda.is_available():
            return True
        reason = "No CUDA device is available."
    console.print(panel(
        f"[err]{reason}[/err]\n\nRun on a machine with an NVIDIA GPU and "
        "PyTorch built for CUDA, or on the CPU with QWEN3_TTS_CPU=1.",
        title="Engine unavailable", border_style="err"))
    return False


def _backend_note() -> str:
    if _cpu_forced():
        return "cpu (QWEN3_TTS_CPU=1)"
    import torch

    return f"{torch.cuda.device_count()}× {torch.cuda.get_device_name(0)}"


def main_menu() -> None:
    clear_screen()
    print_banner()
    console.print(f"[dim]backend: {_backend_note()}[/dim]\n")
    for key, spec in config.MODELS.items():
        present = get_smart_path(spec.folder) is not None
        dot = "[ok]●[/ok]" if present else "[dim]○[/dim]"
        console.print(
            f"  [key]{key}[/key]. {spec.icon} {spec.name:14s} {dot} "
            f"[dim]{spec.description}[/dim]"
        )
    console.print("  [key]q[/key]. Quit\n")

    choice = instant_menu_choice({"1", "2", "3", "q"}, allow_escape=False)
    if choice == "q":
        raise SystemExit(0)
    spec = config.MODELS[choice]
    if spec.mode == "custom":
        run_custom_session(choice)
    elif spec.mode == "design":
        run_design_session(choice)
    elif spec.mode == "clone_manager":
        run_clone_manager(choice)


def main() -> None:
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    warnings.filterwarnings("ignore")
    if not _engine_check():
        raise SystemExit(1)
    # the app owns an engine on the card for the whole session: a second
    # engine-owning process waits for the lock instead of allocating into
    # the same memory (a short wait: the user is waiting). No lock on the
    # CPU.
    from .device_lock import LOCK_PATH, device_lock

    wait = float(os.environ.get("QWEN3_TTS_DEVICE_LOCK_WAIT_S", 120))
    if not device_lock(wait_s=wait, label="app"):
        console.print(
            "[err]The GPU is busy (another engine-owning process holds "
            f"{LOCK_PATH}).[/err]\nRetry later, or run on the CPU with "
            "QWEN3_TTS_CPU=1."
        )
        raise SystemExit(1)
    os.makedirs(config.BASE_OUTPUT_DIR, exist_ok=True)
    while True:
        try:
            main_menu()
        except SystemExit:
            raise
        except (KeyboardInterrupt, EOFError):
            console.print("\n[dim]bye[/dim]")
            raise SystemExit(0)
        except BackSignal:
            continue
        except Exception as exc:  # a failed session returns to the menu
            console.print(f"[err]Unexpected error:[/err] {exc}")
            continue


if __name__ == "__main__":
    main()
