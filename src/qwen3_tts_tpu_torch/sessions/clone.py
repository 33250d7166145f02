"""Voice Cloning manager: saved-voice clone, enroll, quick clone, delete,
update (the JAX package's sessions/clone.py). A missing transcript is
replaced by ``"."`` after the ASR offer; each saved voice writes into its
own output subfolder, a quick clone into ``Clones/QuickClones``.
"""

from __future__ import annotations

import gc
import os

from .. import config
from ..io import (
    clean_path,
    cleanup_temp_dir,
    ensure_model,
    get_text_input,
    load_model_with_progress,
    make_temp_dir,
    save_audio_file,
)
from ..transcription import asr_available, offer_transcribe
from ..ui import BackSignal, clear_screen, console, instant_menu_choice, safe_line_input
from ..voices import (
    delete_voice,
    enroll_new_voice,
    load_voice_transcript,
    pick_saved_voice,
    update_voice,
    voice_paths,
)

#: the transcript placeholder when none is available
NO_TRANSCRIPT = "."


def _generate_loop(model, ref_audio: str, ref_text: str, out_subfolder: str) -> None:
    """Shared generate loop for saved and quick clones."""
    from ..engine import generate_audio  # lazy engine import

    clear_screen()
    console.print(
        f"[ok]Cloning from:[/ok] [dim]{os.path.basename(ref_audio)}[/dim]  "
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
                    ref_audio=ref_audio,
                    ref_text=ref_text,
                    output_path=temp_dir,
                )
            save_audio_file(temp_dir, out_subfolder, text)
        except KeyboardInterrupt:
            console.print("\n[warn]Generation interrupted.[/warn]")
        except Exception as exc:
            console.print(f"[err]Generation failed:[/err] {exc}")
        finally:
            cleanup_temp_dir(temp_dir)


def _load_base_model():
    spec = config.MODELS["3"]
    model_path = ensure_model(spec)
    if model_path is None:
        return None, spec
    return load_model_with_progress(model_path, "Base Model"), spec


def _clone_saved(model, spec: config.ModelSpec) -> None:
    """Clone using an enrolled voice."""
    name = pick_saved_voice()
    if name is None:
        return
    wav, _ = voice_paths(name)
    if not os.path.exists(wav):
        console.print(f"[err]Voice audio missing:[/err] {wav}")
        return
    ref_text = load_voice_transcript(name) or NO_TRANSCRIPT
    if ref_text == NO_TRANSCRIPT and asr_available():
        # transcript absent: offer ASR
        ref_text = offer_transcribe(wav) or NO_TRANSCRIPT
    _generate_loop(
        model, wav, ref_text, os.path.join(spec.output_subfolder, name)
    )


def _quick_clone(model, spec: config.ModelSpec) -> None:
    """One-off clone from a dragged-in audio file, not saved to the library.
    Output goes to Clones/QuickClones."""
    from ..io import convert_audio_if_needed

    console.print("[accent]Drag in the reference audio file[/accent]")
    try:
        raw = safe_line_input("> ").strip()
    except (EOFError, KeyboardInterrupt):
        return
    if not raw:
        return
    path = clean_path(raw)
    if not os.path.exists(path):
        console.print(f"[err]File not found:[/err] {path}")
        return
    converted, is_temp = convert_audio_if_needed(path)
    if converted is None:
        return
    try:
        console.print(
            "[accent]Transcript of the reference audio[/accent] "
            "[dim](empty = none)[/dim]"
        )
        try:
            ref_text = safe_line_input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            ref_text = ""
        if not ref_text:
            if asr_available():
                ref_text = offer_transcribe(converted) or NO_TRANSCRIPT
            else:
                ref_text = NO_TRANSCRIPT
        _generate_loop(
            model,
            converted,
            ref_text,
            os.path.join(spec.output_subfolder, "QuickClones"),
        )
    finally:
        # the converted reference is ours to delete
        if is_temp:
            try:
                os.remove(converted)
            except OSError:
                pass


def run_clone_manager(model_key: str = "3") -> None:
    """Voice Cloning submenu loop; the base model loads at the first
    clone and stays for the rest of the menu."""
    model = None
    spec = config.MODELS[model_key]
    try:
        while True:
            console.print(
                "\n[accent]Voice Cloning[/accent]\n"
                "  [key]1[/key]. Clone with a saved voice\n"
                "  [key]2[/key]. Enroll a new voice\n"
                "  [key]3[/key]. Quick clone (one-off file)\n"
                "  [key]4[/key]. Delete a voice\n"
                "  [key]5[/key]. Update a voice\n"
                "  [key]b[/key]. Back"
            )
            try:
                choice = instant_menu_choice({"1", "2", "3", "4", "5", "b"})
            except (BackSignal, EOFError, KeyboardInterrupt):
                return
            if choice == "b":
                return
            if choice == "2":
                enroll_new_voice()
                continue
            if choice == "4":
                delete_voice()
                continue
            if choice == "5":
                update_voice()
                continue
            # options 1 and 3 need the model
            if model is None:
                model, spec = _load_base_model()
                if model is None:
                    return
            if choice == "1":
                _clone_saved(model, spec)
            elif choice == "3":
                _quick_clone(model, spec)
    finally:
        del model
        gc.collect()
