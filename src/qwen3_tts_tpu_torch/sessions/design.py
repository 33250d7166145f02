"""Voice Design session: voice-from-description -> generate loop (the
JAX package's sessions/design.py; the engine is called with
``instruct=<description>``).
"""

from __future__ import annotations

import gc

from .. import config
from ..io import (
    cleanup_temp_dir,
    ensure_model,
    get_text_input,
    load_model_with_progress,
    make_temp_dir,
    save_audio_file,
)
from ..ui import BackSignal, clear_screen, console, panel, safe_line_input

_TIPS = (
    "Describe the voice you want — age, gender, accent, timbre, pace, mood.\n"
    "Examples:\n"
    "  • A warm, deep male radio host voice, slow and reassuring\n"
    "  • An energetic young woman with a light British accent\n"
    "  • A gravelly old wizard, speaking slowly with dramatic pauses"
)


def run_design_session(model_key: str = "2") -> None:
    """Full Voice Design workflow: load the model, read a voice
    description, then generate until the user backs out."""
    from ..engine import generate_audio  # lazy engine import

    spec = config.MODELS[model_key]
    model_path = ensure_model(spec)
    if model_path is None:
        return
    model = load_model_with_progress(model_path, spec.name)
    if model is None:
        return

    try:
        console.print(panel(_TIPS, title="Voice Design"))
        try:
            description = safe_line_input(
                "[accent]Voice description[/accent] [dim](empty = back)[/dim] > "
            ).strip()
        except (EOFError, KeyboardInterrupt):
            return
        if not description:
            return

        clear_screen()
        console.print(f"[ok]Voice:[/ok] [dim]{description}[/dim]")
        while True:
            try:
                text = get_text_input()
            except BackSignal:
                return
            if text is None:
                return
            temp_dir = make_temp_dir()
            try:
                with console.status("[accent]Generating…[/accent]"):
                    generate_audio(
                        model=model,
                        text=text,
                        instruct=description,
                        output_path=temp_dir,
                    )
                save_audio_file(temp_dir, spec.output_subfolder, text)
            except KeyboardInterrupt:
                console.print("\n[warn]Generation interrupted.[/warn]")
            except Exception as exc:
                console.print(f"[err]Generation failed:[/err] {exc}")
            finally:
                cleanup_temp_dir(temp_dir)
    finally:
        del model
        gc.collect()
