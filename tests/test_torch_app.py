"""The port's terminal app (config, ui, io, voices, sessions, app) against
the JAX package's: the registry and presets, the UI helpers, the io layer
(paths, the stubbed hub download, saved names, text input), the three
sessions driven by the same scripts with ``generate_audio`` stubbed in
both packages (the same calls, reference samples and saved files), each
session end to end on a tiny CPU model, the voice library, the ASR offer,
and the app itself in a pty."""

import dataclasses
import datetime
import importlib
import os
import pty
import re
import select
import subprocess
import sys
import time
import types
import wave
from io import BytesIO
from pathlib import Path

import numpy as np
import pytest

from qwen3_tts_tpu import config as jconfig
from qwen3_tts_tpu import io as jio
from qwen3_tts_tpu import ui as jui
from qwen3_tts_tpu_torch import app, config, io, transcription, ui, voices
from qwen3_tts_tpu_torch.engine import configs as tcfgs

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("qwen3_tts_tpu", "qwen3_tts_tpu_torch")
TIMEOUT = 30  # the pty's and every subprocess's bound


# -- config and ui -----------------------------------------------------------

def test_registry_and_presets_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in config.MODELS.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.MODELS.items()}
    assert config.SPEAKER_MAP == jconfig.SPEAKER_MAP
    assert config.all_speakers() == jconfig.all_speakers()
    assert config.EMOTION_PRESETS == jconfig.EMOTION_PRESETS
    assert config.SPEED_PRESETS == jconfig.SPEED_PRESETS
    for name in ("AUTO_PLAY", "SAMPLE_RATE", "FILENAME_MAX_LEN",
                 "MAX_TEXT_LENGTH"):
        assert getattr(config, name) == getattr(jconfig, name)


@pytest.mark.parametrize("text", [
    "plain", "[accent]hello[/accent]", "[err]bad[/err] and [ok]good[/ok]",
    "[key]1[/key]. Custom [dim]×1.3[/dim]", "", "  spaced\tout \n",
    "[bold red]x[/bold red] [warn]careful[/warn]"])
def test_ui_helpers_equal_jax(text):
    assert ui.markup_to_ansi(text) == jui.markup_to_ansi(text)
    assert ui.normalize_whitespace(text) == jui.normalize_whitespace(text)


def test_console_is_built_at_first_use():
    fresh = ui.ThemedConsole()
    assert fresh._console is None
    assert fresh.width > 0 and fresh._console is not None
    assert "Voice Design" in str(ui.panel("body", title="Voice Design").title)


# -- io ----------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["  '/tmp/a b.wav'  ", '"/tmp/x.wav"',
                                 "/tmp/a\\ b.wav", "~/voice.wav", "plain"])
def test_clean_path_equals_jax(raw):
    assert io.clean_path(raw) == jio.clean_path(raw)


@pytest.mark.parametrize("layout", ["flat", "snapshots", "empty_snapshots",
                                    "missing"])
def test_get_smart_path_equals_jax(temp_dir, monkeypatch, layout):
    folder = os.path.join(temp_dir, "m")
    if layout == "flat":
        os.makedirs(folder)
    elif layout == "snapshots":
        os.makedirs(os.path.join(folder, "snapshots", "abc123"))
        os.makedirs(os.path.join(folder, "snapshots", ".hidden"))
    elif layout == "empty_snapshots":
        os.makedirs(os.path.join(folder, "snapshots"))
    for mod in (io, jio):
        monkeypatch.setattr(mod, "MODELS_DIR", temp_dir)
    got = io.get_smart_path("m")
    assert got == jio.get_smart_path("m")
    assert got == {"flat": folder, "missing": None, "empty_snapshots": None,
                   "snapshots": os.path.join(folder, "snapshots", "abc123")
                   }[layout]


@pytest.mark.parametrize("outcome", ["ok", "interrupted", "failed"])
def test_ensure_model_with_the_hub_stubbed_equals_jax(temp_dir, monkeypatch,
                                                      outcome):
    """snapshot_download stubbed (no network): a download that lands, a
    Ctrl-C that removes the partial directory, a failure that returns
    None; both packages the same."""
    def snapshot_download(repo_id, local_dir):
        os.makedirs(os.path.join(local_dir, "snapshots", "rev0"))
        if outcome == "interrupted":
            raise KeyboardInterrupt
        if outcome == "failed":
            raise OSError("offline")

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        snapshot_download=snapshot_download))
    results = []
    for mod, spec in ((io, config.MODELS["1"]), (jio, jconfig.MODELS["1"])):
        root = os.path.join(temp_dir, mod.__name__)
        monkeypatch.setattr(mod, "MODELS_DIR", root)
        got = mod.ensure_model(spec)
        results.append((got and os.path.relpath(got, root),
                        os.path.isdir(os.path.join(root, spec.folder))))
    assert results[0] == results[1]
    assert results[0] == {
        "ok": (os.path.join(config.MODELS["1"].folder, "snapshots", "rev0"),
               True),
        "interrupted": (None, False), "failed": (None, True)}[outcome]


class _FrozenClock:
    """Stands in for datetime.datetime (tests patch the module's class, so
    the instant is built from the real class, kept at import)."""

    _instant = datetime.datetime(2026, 1, 1, 12, 0, 0)

    @classmethod
    def now(cls):
        return cls._instant


def test_save_audio_file_names_equal_jax(temp_dir, monkeypatch):
    """Timestamped names from the text snippet, collision suffixes _1, _2;
    a missing audio_000.wav saves nothing."""
    monkeypatch.setattr(io._dt, "datetime", _FrozenClock)
    monkeypatch.setattr(io.time, "sleep", lambda s: None)
    names = {}
    for mod in (io, jio):
        out = os.path.join(temp_dir, mod.__name__)
        monkeypatch.setattr(mod, "BASE_OUTPUT_DIR", out)
        monkeypatch.setattr(mod, "AUTO_PLAY", False)
        monkeypatch.setattr(mod, "clear_screen", lambda: None)
        saved = []
        for i, text in enumerate(["Hello, world! A long sentence here.",
                                  "Hello, world! A long sentence here.",
                                  "Hello, world! A long sentence here.",
                                  "!!!"]):
            gen = os.path.join(temp_dir, f"gen_{mod.__name__}_{i}")
            os.makedirs(gen)
            with wave.open(os.path.join(gen, mod.ENGINE_AUDIO_NAME),
                           "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(24_000)
                w.writeframes(np.zeros(240, np.int16).tobytes())
            saved.append(os.path.relpath(mod.save_audio_file(gen, "Sub", text),
                                         out))
            assert not os.path.exists(gen)
        empty = os.path.join(temp_dir, f"empty_{mod.__name__}")
        os.makedirs(empty)
        assert mod.save_audio_file(empty, "Sub", "x") is None
        names[mod] = saved
    assert names[io] == names[jio] == [
        "Sub/12-00-00_Hello_world_A_long_s.wav",
        "Sub/12-00-00_Hello_world_A_long_s_1.wav",
        "Sub/12-00-00_Hello_world_A_long_s_2.wav", "Sub/12-00-00_audio.wav"]


@pytest.mark.parametrize("kind", ["typed", "txt_drop", "too_long", "blank",
                                  "eof"])
def test_get_text_input_equals_jax(temp_dir, monkeypatch, kind):
    txt = os.path.join(temp_dir, "my text.txt")
    with open(txt, "w") as fh:
        fh.write("  words from a file  \n")
    line = {"typed": "  hello there  ", "txt_drop": f"'{txt}'",
            "too_long": "x" * 40, "blank": "   ", "eof": None}[kind]

    def read(prompt=""):
        if line is None:
            raise EOFError
        return line

    got = []
    for mod, u in ((io, ui), (jio, jui)):
        monkeypatch.setattr(mod, "MAX_TEXT_LENGTH", 25)
        monkeypatch.setattr(u, "safe_line_input", read)
        got.append(mod.get_text_input())
    assert got[0] == got[1] == {
        "typed": "hello there", "txt_drop": "words from a file",
        "too_long": "x" * 25, "blank": None, "eof": None}[kind]


# -- sessions: the same calls as the JAX sessions ----------------------------

class Script:
    """One queue of scripted answers for every line prompt and menu of a
    session; an exhausted script is Ctrl-D, an empty menu answer Escape."""

    def __init__(self, lines, back_signal):
        self.lines = list(lines)
        self.back_signal = back_signal

    def __call__(self, prompt=""):
        if not self.lines:
            raise EOFError
        return self.lines.pop(0)

    def menu(self, keys, *args, **kwargs):
        key = self()
        if key == "":
            raise self.back_signal()
        return key


class Recorder:
    """A console stand-in: every printed line, and status() as a no-op."""

    def __init__(self):
        self.lines = []

    def print(self, *objects, **kwargs):
        self.lines.append(" ".join(str(o) for o in objects))

    def status(self, *args, **kwargs):
        import contextlib

        return contextlib.nullcontext()


def _modules(pkg):
    names = ("io", "ui", "voices", "transcription", "engine",
             "sessions.custom", "sessions.design", "sessions.clone")
    return types.SimpleNamespace(**{n.split(".")[-1]: importlib.import_module(
        f"{pkg}.{n}") for n in names})


def _wav_payload(path):
    with wave.open(path, "rb") as w:
        return (w.getframerate(), w.getnchannels(), w.getsampwidth(),
                w.readframes(w.getnframes()))


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def drive(monkeypatch, pkg, root, session, lines, *, model_paths=None,
          generate=None, console=None):
    """Run ``session`` (custom | design | clone) of ``pkg`` on scripted
    ``lines`` with the sleep and clear stubbed, ASR off and the outputs and
    voice library under ``root``. Without ``generate``, ensure_model,
    the model load and generate_audio are stubbed and recorded (and the
    garbage collection after the session skipped). Returns
    (calls, the saved outputs, the voice library)."""
    m = _modules(pkg)
    calls = []
    script = Script(lines, m.ui.BackSignal)
    out, lib = os.path.join(root, "out"), os.path.join(root, "voices")
    monkeypatch.setattr(m.io, "BASE_OUTPUT_DIR", out)
    monkeypatch.setattr(m.io, "AUTO_PLAY", False)
    monkeypatch.setattr(m.io._dt, "datetime", _FrozenClock)
    monkeypatch.setattr(m.io.time, "sleep", lambda s: None)
    monkeypatch.setattr(m.voices, "VOICES_DIR", lib)
    monkeypatch.setattr(m.transcription, "_providers", {})
    monkeypatch.setattr(m.transcription, "_whisper_model_dir", lambda: None)
    sessions = (m.custom, m.design, m.clone)
    for mod in (m.io, *sessions):
        monkeypatch.setattr(mod, "clear_screen", lambda: None)
    for mod in (m.ui, m.voices, *sessions):
        monkeypatch.setattr(mod, "safe_line_input", script)
    monkeypatch.setattr(m.clone, "instant_menu_choice", script.menu)
    if console is not None:
        for mod in (m.ui, m.io, m.voices, *sessions):
            monkeypatch.setattr(mod, "console", console)
    for mod, mode in zip(sessions, ("custom", "design", "base")):
        path = (model_paths or {}).get(mode, f"fake:{mode}")
        monkeypatch.setattr(mod, "ensure_model", lambda spec, p=path: p)
    if generate is None:
        for mod in sessions:
            monkeypatch.setattr(
                mod, "load_model_with_progress",
                lambda path, name: calls.append(("load", path, name)) or path)
            # no model to free: skip the full collection each session
            # ends with (slow with torch and jax loaded)
            monkeypatch.setattr(mod, "gc", types.SimpleNamespace(
                collect=lambda: 0))

        def generate(model, text, output_path, ref_audio=None, **kw):
            ref = _wav_payload(ref_audio) if ref_audio else None
            calls.append(("generate", model, text, sorted(kw.items()), ref))
            with wave.open(os.path.join(output_path, "audio_000.wav"),
                           "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(24_000)
                w.writeframes(np.arange(240, dtype=np.int16).tobytes())

        monkeypatch.setattr(m.engine, "generate_audio", generate)
    run = {"custom": m.custom.run_custom_session,
           "design": m.design.run_design_session,
           "clone": m.clone.run_clone_manager}[session]
    run()
    return calls, _tree(out), _tree(lib)


@pytest.fixture(scope="module")
def ref44k(tmp_path_factory):
    """A 1 s 44.1 kHz stereo 16-bit reference (conversion resamples and
    mixes it down)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref voice.wav")
    t = np.arange(44_100) / 44_100
    left = (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * np.sin(2 * np.pi * 3_000 * t))
    stereo = np.stack([left, 0.5 * left], axis=1)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44_100)
        w.writeframes((stereo * 32767).astype(np.int16).tobytes())
    return path


REF = "<ref>"  # replaced by the reference's path
BASE_SCRIPTS = {
    "custom": ["1", "6", "a calm custom style", "3", "Hello there, general.",
               "Second line.", ""],
    "design": ["a warm narrator with a deep voice", "Designed voice.", ""],
    "quick_clone": ["3", REF, "a reference transcript", "Cloned speech.", "",
                    "b"],
    "saved_clone": ["2", "My Voice!", REF, "the words", "1", "1",
                    "Hello clone.", "", "b"],
    "library": ["2", "alpha", REF, "", "5", "1", REF, "new words", "5", "1",
                "", "", "4", "1", "n", "4", "1", "y", "1", "b"],
}
SESSION_OF = {"custom": "custom", "design": "design"}

CASES = {}
for emo in sorted(config.EMOTION_PRESETS):
    for spd in sorted(config.SPEED_PRESETS):
        CASES[f"custom-emotion{emo}-speed{spd}"] = (
            "custom", ["1", emo] + (["my own style"] if emo == "6" else [])
            + [spd, "Hello there.", ""])
for name, lines in BASE_SCRIPTS.items():
    CASES[name] = (SESSION_OF.get(name, "clone"), lines)
    for k in range(len(lines)):  # Ctrl-D, then back, at each prompt
        CASES[f"{name}-eof@{k}"] = (SESSION_OF.get(name, "clone"), lines[:k])
        if lines[k] != "":
            CASES[f"{name}-back@{k}"] = (SESSION_OF.get(name, "clone"),
                                         lines[:k] + ["", "b"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_session_calls_equal_jax(case, temp_dir, monkeypatch, ref44k):
    """The JAX session and the port's on one script, generate_audio
    stubbed in both: the same model loads, the same generate_audio
    arguments (text, voice, instruct, speed, ref_text and the reference's
    converted samples), the same saved files and voice library."""
    session, lines = CASES[case]
    lines = [ref44k if ln == REF else ln for ln in lines]
    got = [drive(monkeypatch, pkg, os.path.join(temp_dir, pkg), session, lines)
           for pkg in PKGS]
    assert got[0] == got[1]
    calls, saved, library = got[1]
    n = sum(c[0] == "generate" for c in calls)
    assert len(saved) == n
    if case.startswith("custom-emotion") or case in (
            "custom", "design", "quick_clone", "saved_clone"):
        assert n >= 1
    if case == "library":  # enrolled, updated twice, kept, then deleted
        assert n == 0 and library == {}
    if case == "saved_clone":  # the enrolled voice is what was cloned
        assert sorted(library) == ["My_Voice.txt", "My_Voice.wav"]
        ref = [c[4] for c in calls if c[0] == "generate"][0]
        assert ref[:3] == (24_000, 1, 2)
        assert list(saved) == [os.path.join("Clones", "My_Voice",
                                            "12-00-00_Hello_clone.wav")]


def _check_saved(saved, hop):
    assert len(saved) == 1, sorted(saved)
    (name, data), = saved.items()
    with wave.open(BytesIO(data), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (
            1, 2, 24_000), name
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    assert len(pcm) >= hop and pcm.any()


ERROR_LINES = ("Generation failed", "Failed to load", "No audio was generated",
               "Could not convert")


@pytest.mark.parametrize("session,lines", [
    ("custom", ["1", "2", "2", "Hello there.", ""]),
    ("design", ["a calm narrator", "Designed voice.", ""]),
    ("clone", ["2", "tiny voice", REF, "the words", "1", "1", "Cloned.", "",
               "b"]),
], ids=["custom", "design", "clone"])
def test_sessions_end_to_end_on_a_tiny_cpu_model(session, lines, temp_dir,
                                                 monkeypatch, ref44k):
    """The real port engine (synthetic:tiny, QWEN3_TTS_CPU=1): each
    session saves exactly one mono 16-bit 24 kHz WAV, with no error line
    on its console."""
    from qwen3_tts_tpu_torch import engine

    monkeypatch.setenv("QWEN3_TTS_CPU", "1")
    rec = Recorder()
    lines = [ref44k if ln == REF else ln for ln in lines]
    _, saved, _ = drive(
        monkeypatch, "qwen3_tts_tpu_torch", temp_dir, session, lines,
        model_paths={m: f"synthetic:tiny:{m}" for m in ("custom", "design",
                                                        "base")},
        generate=engine.generate_audio, console=rec)
    _check_saved(saved, tcfgs.tiny().codec.hop)
    assert not [ln for ln in rec.lines if any(e in ln for e in ERROR_LINES)]
    assert any("loaded" in ln for ln in rec.lines)


# -- the voice library and the ASR offer -------------------------------------

def _mk_voice(store, name, transcript=None, n=2400):
    os.makedirs(store, exist_ok=True)
    with wave.open(os.path.join(store, f"{name}.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24_000)
        w.writeframes(np.zeros(n, np.int16).tobytes())
    if transcript:
        with open(os.path.join(store, f"{name}.txt"), "w") as fh:
            fh.write(transcript)


@pytest.fixture
def library(temp_dir, monkeypatch):
    store = os.path.join(temp_dir, "voices")
    monkeypatch.setattr(voices, "VOICES_DIR", store)
    monkeypatch.setattr(transcription, "_providers", {})
    monkeypatch.setattr(transcription, "_whisper_model_dir", lambda: None)

    def script(lines):
        monkeypatch.setattr(voices, "safe_line_input",
                            Script(lines, ui.BackSignal))
    return store, script


def test_enroll_voice(library, ref44k):
    store, script = library
    script(["My Test Voice!", ref44k, "the transcript text"])
    name = voices.enroll_new_voice()
    assert name == "My_Test_Voice"
    wav, txt = voices.voice_paths(name)
    assert open(txt).read() == "the transcript text"
    with wave.open(wav, "rb") as w:  # converted: mono 16-bit 24 kHz
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (
            1, 2, 24_000)
    assert voices.get_saved_voices() == [name]


@pytest.mark.parametrize("answer,deleted", [("y", True), ("n", False)])
def test_delete_voice(library, answer, deleted):
    store, script = library
    _mk_voice(store, "alpha", "hello")
    _mk_voice(store, "beta")
    script(["1", answer])
    assert voices.delete_voice() is deleted
    assert voices.get_saved_voices() == (["beta"] if deleted
                                         else ["alpha", "beta"])
    assert os.path.exists(os.path.join(store, "alpha.txt")) is not deleted


@pytest.mark.parametrize("with_audio", [False, True],
                         ids=["transcript_only", "audio"])
def test_update_voice(library, ref44k, with_audio):
    store, script = library
    _mk_voice(store, "alpha", "old words")
    script(["1", ref44k if with_audio else "", "new words"])
    assert voices.update_voice() == "alpha"
    assert voices.load_voice_transcript("alpha") == "new words"
    with wave.open(voices.voice_paths("alpha")[0], "rb") as w:
        n = w.getnframes()
    assert n == (24_000 if with_audio else 2400)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("answer,provider,want", [
    ("y", True, "spoken words"), ("n", True, None), (None, True, None),
    ("y", False, None)], ids=["yes", "no", "eof", "no_provider"])
def test_offer_transcribe(pkg, answer, provider, want, temp_dir, monkeypatch):
    """The transcript on y; None on n, on Ctrl-D, and without a provider
    (both packages)."""
    m = _modules(pkg)
    monkeypatch.setattr(m.transcription, "_whisper_model_dir", lambda: None)
    monkeypatch.setattr(m.transcription, "_providers", {
        "fake": lambda path: "spoken words"} if provider else {})
    monkeypatch.setattr(m.ui, "safe_line_input", Script(
        [] if answer is None else [answer], m.ui.BackSignal))
    wav = os.path.join(temp_dir, "ref.wav")
    _mk_voice(temp_dir, "ref")
    assert m.transcription.offer_transcribe(wav) == want


# -- the app -----------------------------------------------------------------

def test_app_imports_without_torch_or_the_engine():
    code = ("import sys; import qwen3_tts_tpu_torch.app;"
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith('qwen3_tts_tpu_torch.engine')]; print(bad)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=TIMEOUT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("key,session", [("1", "run_custom_session"),
                                         ("2", "run_design_session"),
                                         ("3", "run_clone_manager")])
def test_main_menu_dispatches(monkeypatch, key, session):
    ran = []
    for name in ("run_custom_session", "run_design_session",
                 "run_clone_manager"):
        monkeypatch.setattr(app, name, lambda k, n=name: ran.append((n, k)))
    monkeypatch.setattr(app, "clear_screen", lambda: None)
    monkeypatch.setattr(app, "console", Recorder())
    monkeypatch.setattr(app, "print_banner", lambda: None)
    monkeypatch.setenv("QWEN3_TTS_CPU", "1")
    monkeypatch.setattr(app, "instant_menu_choice", lambda keys, **kw: key)
    app.main_menu()
    assert ran == [(session, key)]
    monkeypatch.setattr(app, "instant_menu_choice", lambda keys, **kw: "q")
    with pytest.raises(SystemExit) as e:
        app.main_menu()
    assert e.value.code == 0


def _pty_run(env, keys_after_menu, timeout=TIMEOUT):
    """Start the app in a pty, wait for its menu, type the keys; returns
    (exit code, output with ANSI escapes removed)."""
    master, slave = pty.openpty()
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.app"], stdin=slave,
        stdout=slave, stderr=slave, env=env, cwd=env["HOME"],
        start_new_session=True)
    os.close(slave)
    out = b""
    deadline = time.monotonic() + timeout
    typed = False
    try:
        while time.monotonic() < deadline and proc.poll() is None:
            if select.select([master], [], [], 0.1)[0]:
                try:
                    out += os.read(master, 4096)
                except OSError:
                    break
            if not typed and b"Quit" in out and b"Press a key" in out:
                os.write(master, keys_after_menu)
                typed = True
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)
    return rc, re.sub(rb"\x1b\[[0-9;?]*[a-zA-Z]", b"", out).decode(
        errors="replace")


def test_app_menu_in_a_pty_then_quit(temp_dir):
    env = {**os.environ, "QWEN3_TTS_CPU": "1", "HOME": temp_dir,
           "PYTHONPATH": str(ROOT / "src"), "TERM": "xterm"}
    rc, out = _pty_run(env, b"q")
    assert rc == 0, out[-2000:]
    for text in ("QWEN3-TTS", "backend: cpu", "Custom Voice", "Voice Design",
                 "Voice Cloning", "Quit"):
        assert text in out, out[-2000:]
    assert os.path.isdir(os.path.join(temp_dir, "outputs"))


def test_app_refuses_without_cuda(temp_dir):
    """No CPU fallback: without a CUDA device and QWEN3_TTS_CPU the app
    prints its panel and exits 1."""
    env = {k: v for k, v in os.environ.items() if k != "QWEN3_TTS_CPU"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "qwen3_tts_tpu_torch.app"],
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=env, cwd=temp_dir, stdin=subprocess.DEVNULL)
    assert proc.returncode == 1
    assert "Engine unavailable" in proc.stdout
    assert "QWEN3_TTS_CPU=1" in proc.stdout
    assert not os.path.exists(os.path.join(temp_dir, "outputs"))
