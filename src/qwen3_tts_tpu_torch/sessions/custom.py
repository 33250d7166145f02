"""Custom Voice session: preset speaker + emotion + speed -> generate loop
(the JAX package's sessions/custom.py). The engine is imported inside the
session, so this module imports without it.
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
from ..ui import BackSignal, clear_screen, console, safe_line_input


def _pick_speaker() -> str | None:
    """Number- or name-based speaker selection across language groups."""
    flat: list[str] = []
    console.print("[accent]Speakers:[/accent]")
    idx = 1
    for lang, names in config.SPEAKER_MAP.items():
        row = []
        for name in names:
            row.append(f"[key]{idx}[/key]. {name}")
            flat.append(name)
            idx += 1
        console.print(f"  [dim]{lang:9s}[/dim] " + "   ".join(row))
    while True:
        try:
            raw = safe_line_input(
                "[dim]number or name (empty = back)[/dim] > "
            ).strip()
        except (EOFError, KeyboardInterrupt):
            return None
        if not raw:
            return None
        if raw.isdigit():
            n = int(raw)
            if 1 <= n <= len(flat):
                return flat[n - 1]
        else:
            for name in flat:
                if name.lower() == raw.lower():
                    return name
        console.print("[warn]Not a valid speaker — try again.[/warn]")


def _pick_emotion() -> str | None:
    """Emotion preset or free-text custom instruct."""
    console.print("[accent]Emotion:[/accent]")
    for key, (label, text) in config.EMOTION_PRESETS.items():
        hint = f"[dim]{text}[/dim]" if text else "[dim]describe your own[/dim]"
        console.print(f"  [key]{key}[/key]. {label} {hint}")
    try:
        raw = safe_line_input("[dim]choice (empty = Normal)[/dim] > ").strip()
    except (EOFError, KeyboardInterrupt):
        return None
    if not raw:
        raw = "1"
    preset = config.EMOTION_PRESETS.get(raw)
    if preset is None:
        return config.EMOTION_PRESETS["1"][1]
    label, text = preset
    if text is not None:
        return text
    try:
        custom = safe_line_input("[accent]Describe the emotion/style:[/accent] > ")
    except (EOFError, KeyboardInterrupt):
        return None
    return custom.strip() or config.EMOTION_PRESETS["1"][1]


def _pick_speed() -> float | None:
    """Speed preset pick."""
    console.print("[accent]Speed:[/accent]")
    for key, (label, value) in config.SPEED_PRESETS.items():
        console.print(f"  [key]{key}[/key]. {label} [dim]×{value}[/dim]")
    try:
        raw = safe_line_input("[dim]choice (empty = Normal)[/dim] > ").strip()
    except (EOFError, KeyboardInterrupt):
        return None
    preset = config.SPEED_PRESETS.get(raw or "1", config.SPEED_PRESETS["1"])
    return preset[1]


def run_custom_session(model_key: str = "1") -> None:
    """Full Custom Voice workflow: load the model, pick speaker, emotion
    and speed, then generate until the user backs out."""
    from ..engine import generate_audio  # lazy engine import

    spec = config.MODELS[model_key]
    model_path = ensure_model(spec)
    if model_path is None:
        return
    model = load_model_with_progress(model_path, spec.name)
    if model is None:
        return

    try:
        speaker = _pick_speaker()
        if speaker is None:
            return
        instruct = _pick_emotion()
        if instruct is None:
            return
        speed = _pick_speed()
        if speed is None:
            return

        clear_screen()
        console.print(
            f"[ok]{speaker}[/ok] [dim]| {instruct} | ×{speed}[/dim]  "
            "[dim](empty text = back)[/dim]"
        )
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
                        voice=speaker.lower(),
                        instruct=instruct,
                        speed=speed,
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
