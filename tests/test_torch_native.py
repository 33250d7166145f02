"""The port's native audio library (``qwen3_tts_tpu_torch.native``) against
the JAX package's: both build from the same C++ arithmetic with the host's
g++, so each of the five functions must give bit-equal results on the same
inputs; the resampler keeps the JAX tests' properties; under
QWEN3_TTS_NATIVE=never every wrapper equals the JAX package's numpy and
scipy path; the port's WAV reader, writer, downmix and ``resample`` equal
the JAX package's at either setting; a failed compile raises."""

import os
import stat
import wave
from pathlib import Path

import numpy as np
import pytest

from qwen3_tts_tpu import native as jnative
from qwen3_tts_tpu.audio import resample as jax_resample
from qwen3_tts_tpu.audio import wavio as jwavio
from qwen3_tts_tpu_torch import native
from qwen3_tts_tpu_torch.audio import read_wav, resample, to_mono, write_wav
from qwen3_tts_tpu_torch.native import build

ROOT = Path(__file__).resolve().parent.parent
RATES = ((48_000, 24_000), (16_000, 24_000), (44_100, 24_000),
         (24_000, 16_000))


@pytest.fixture(scope="module")
def both_built():
    if build.compiler() is None or not jnative.native_available():
        pytest.skip("no C++ compiler on this host: both packages use numpy")
    assert native.native_available()


def _sine(freq, rate, seconds=0.5):
    t = np.arange(int(rate * seconds)) / rate
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def _noise(n, seed=0, scale=0.6):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)


def test_library_builds_into_build_native(both_built):
    lib = build.ensure_built()
    assert lib.parent == ROOT / "build" / "native"
    assert lib.name.startswith("libq3tts_audio_") and lib.suffix == ".so"
    assert lib.exists() and lib.with_suffix(".log").exists()
    assert build.library_path() == lib  # a second call loads, no rebuild


EDGES = np.array([0.0, 1.0, -1.0, 2.0, -2.0, 0.5 / 32767, -0.5 / 32767,
                  1.5 / 32767, -1.5 / 32767, 2.5 / 32767, -2.5 / 32767],
                 np.float32)


def _inputs(fn):
    x = _noise(9_001, seed=3, scale=0.8)
    return {
        "f32_to_i16": (np.concatenate([EDGES, x * 1.5]),),
        "i16_to_f32": (np.concatenate([
            np.array([-32768, -1, 0, 1, 32767], np.int16),
            np.random.default_rng(4).integers(-32768, 32767, 9_000,
                                              dtype=np.int16)]),),
        "downmix_mono": (x[:9_000].reshape(-1, 3),),
        "peak": (x,),
    }[fn]


@pytest.mark.parametrize("src,dst", RATES)
def test_resample_bit_equal_to_jax(both_built, src, dst):
    x = _noise(src // 2 + 17, seed=src)
    np.testing.assert_array_equal(native.resample_native(x, src, dst),
                                  jnative.resample_native(x, src, dst))


@pytest.mark.parametrize("fn", ["f32_to_i16", "i16_to_f32", "downmix_mono",
                                "peak"])
def test_pcm_downmix_peak_bit_equal_to_jax(both_built, fn, monkeypatch):
    """Bit-equal to the JAX package's library; and to the port's own numpy
    path (as chip_smoke.py holds them on the card's host), the downmix on
    two channels."""
    args = _inputs(fn)
    got, want = getattr(native, fn)(*args), getattr(jnative, fn)(*args)
    assert type(got) is type(want)
    np.testing.assert_array_equal(got, want)
    if fn == "downmix_mono":  # stereo too (the common reference)
        args = (_noise(4_000, seed=5).reshape(-1, 2),)
        got = native.downmix_mono(*args)
        np.testing.assert_array_equal(got, jnative.downmix_mono(*args))
    monkeypatch.setenv("QWEN3_TTS_NATIVE", "never")
    np.testing.assert_array_equal(getattr(native, fn)(*args), got)


def test_resample_identity(both_built):
    x = _sine(440.0, 24_000)
    np.testing.assert_array_equal(native.resample_native(x, 24_000, 24_000), x)


@pytest.mark.parametrize("src,dst", RATES[:3])
def test_resample_length_and_tone(both_built, src, dst):
    """Length ceil(n * dst / src) and a 1 kHz tone's energy kept (> 0.99
    of it in the tone's quadrature pair, filter edges skipped)."""
    x = _sine(1000.0, src)
    y = native.resample_native(x, src, dst)
    assert abs(len(y) - int(np.ceil(len(x) * dst / src))) <= 1
    t = np.arange(len(y)) / dst
    body = slice(len(y) // 8, -len(y) // 8)
    c = np.sin(2 * np.pi * 1000.0 * t)[body]
    s = np.cos(2 * np.pi * 1000.0 * t)[body]
    yb = y[body].astype(np.float64)
    proj = (np.dot(yb, c) ** 2 / np.dot(c, c)
            + np.dot(yb, s) ** 2 / np.dot(s, s))
    assert proj / np.sum(yb * yb) > 0.99


def test_resample_attenuates_above_nyquist(both_built):
    """20 kHz at 48 kHz, above the 12 kHz Nyquist of 24 kHz: > 34 dB down."""
    x = _sine(20_000.0, 48_000)
    y = native.resample_native(x, 48_000, 24_000)
    body = y[len(y) // 8: -len(y) // 8].astype(np.float64)
    assert np.sqrt(np.mean(body ** 2)) < 0.02 * np.sqrt(
        np.mean(x.astype(np.float64) ** 2))


@pytest.fixture
def jax_never(monkeypatch):
    """Both packages under QWEN3_TTS_NATIVE=never (the JAX package reads
    it once, at its library's first load)."""
    monkeypatch.setenv("QWEN3_TTS_NATIVE", "never")
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)


@pytest.mark.parametrize("fn", ["f32_to_i16", "i16_to_f32", "downmix_mono",
                                "peak", "resample"])
def test_never_equals_the_jax_numpy_and_scipy_path(jax_never, fn):
    assert native._load() is None and not native.native_available()
    if fn == "resample":
        x = _noise(8_000, seed=6)
        assert native.resample_native(x, 16_000, 24_000) is None
        np.testing.assert_array_equal(resample(x, 16_000, 24_000),
                                      jax_resample(x, 16_000, 24_000))
        return
    args = _inputs(fn)
    np.testing.assert_array_equal(getattr(native, fn)(*args),
                                  getattr(jnative, fn)(*args))


@pytest.mark.parametrize("setting", ["auto", "never"])
def test_wav_io_and_resample_equal_jax(temp_dir, monkeypatch, setting,
                                       request):
    """A 44.1 kHz stereo 16-bit WAV written, read, mixed down and
    resampled to 24 kHz by each package: equal bytes and samples."""
    if setting == "never":
        request.getfixturevalue("jax_never")
    else:
        request.getfixturevalue("both_built")
    stereo = np.stack([_noise(4_410, 7, 0.5), _noise(4_410, 8, 0.5)], axis=1)
    ours, theirs = (os.path.join(temp_dir, f"{n}.wav") for n in ("t", "j"))
    write_wav(ours, stereo, 44_100)
    jwavio.write_wav(theirs, stereo, 44_100)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    data, rate = read_wav(ours)
    jdata, jrate = jwavio.read_wav(ours)
    assert rate == jrate == 44_100
    np.testing.assert_array_equal(data, jdata)
    mono = to_mono(data)
    np.testing.assert_array_equal(mono, jwavio.to_mono(jdata))
    np.testing.assert_array_equal(resample(mono, 44_100, 24_000),
                                  jax_resample(mono, 44_100, 24_000))


@pytest.fixture
def fresh_build(monkeypatch, temp_dir):
    """The build module pointed at an empty directory, the bindings at
    their first load."""
    monkeypatch.setattr(build, "BUILD_DIR", Path(temp_dir) / "native")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_NO_COMPILER", False)
    monkeypatch.delenv("QWEN3_TTS_NATIVE", raising=False)
    return Path(temp_dir)


def test_a_failed_compile_raises_with_its_log(fresh_build, monkeypatch):
    cxx = fresh_build / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'audio_kernels.cpp:1: error: boom' >&2\n"
                   "exit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="error: boom"):
        native.f32_to_i16(np.zeros(4, np.float32))
    lib = build.library_path()
    assert not lib.exists()
    assert "error: boom" in lib.with_suffix(".log").read_text()
    assert [p.name for p in lib.parent.iterdir()] == [
        lib.with_suffix(".log").name]  # no temp file left behind


def test_no_compiler_means_the_numpy_path(fresh_build, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    assert build.ensure_built() is None
    assert not native.native_available()
    x = np.array([0.0, 0.5, -0.5, 1.0], np.float32)
    assert native.f32_to_i16(x).tolist() == [0, 16384, -16384, 32767]
    assert native.resample_native(x, 16_000, 24_000) is None


def test_concurrent_builds_converge(both_built, fresh_build):
    """Processes building one library at once (as test workers do) each
    end with the whole library: pid-unique temp files, one atomic rename
    each."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from pathlib import Path;"
            "from qwen3_tts_tpu_torch.native import build;"
            "build.BUILD_DIR = Path(sys.argv[2]);"
            "print(build.ensure_built())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(ROOT / "src"),
                               str(build.BUILD_DIR)], stdout=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1 and outs[0] == str(build.library_path())
    assert sorted(p.suffix for p in build.BUILD_DIR.iterdir()) == [".log",
                                                                   ".so"]
    # the library each process built loads and computes
    assert native.peak(np.array([0.25, -0.75], np.float32)) == 0.75
    with wave.open(os.path.join(fresh_build, "x.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24_000)
        w.writeframes(np.array([16384, -16384], np.int16).tobytes())
    np.testing.assert_array_equal(
        read_wav(os.path.join(fresh_build, "x.wav"))[0], [0.5, -0.5])
