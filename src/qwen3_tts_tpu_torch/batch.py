"""Offline batch synthesis: bulk text-to-speech through the serving
engine (the JAX package's batch.py).

A decode step reads every weight once whatever the number of rows, so N
concurrent streams share each step and aggregate throughput grows with N.
This module points a file of utterances at one continuous-batching
``TTSService`` (server.py), writing one WAV per item plus a JSONL
manifest.

Input formats (``--input``):

- ``.jsonl``: one JSON object per line,
  ``{"id"?, "text", "voice"?, "instruct"?, "speed"?, "saved_voice"?,
  "ref_audio"?, "ref_text"?, "max_seconds"?}``. Unknown keys are rejected
  (a typo'd field silently falling back to defaults would corrupt a whole
  batch).
- anything else: plain text, one utterance per line (blank lines and
  ``#`` comments skipped); per-item options come from the CLI defaults.

Outputs, under ``--output``:

- ``<id>.wav`` per item (24 kHz mono 16-bit PCM; ``id`` defaults to the
  zero-padded input line number);
- ``manifest.jsonl``: one row per item, ``{"id", "ok", "wav"?,
  "seconds"?, "ttfa_s"?, "error"?}``, appended as items complete;
- a final summary line on stdout: items, failures, audio seconds, wall
  seconds, aggregate RTF.

``--resume`` skips items whose manifest row says ``ok`` (the manifest, not
the WAV's existence, is the source of truth: a crash can leave a partial
WAV behind).

Run as ``python -m qwen3_tts_tpu_torch.batch --model <ckpt> --input
texts.txt --output out/`` (the CUDA device; QWEN3_TTS_CPU=1 for the CPU).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

_ITEM_KEYS = {
    "id", "text", "voice", "instruct", "speed",
    "saved_voice", "ref_audio", "ref_text", "max_seconds",
}


def parse_items(path: str, defaults: dict[str, Any]) -> list[dict[str, Any]]:
    """Read the input file into a list of per-item dicts (id + submit-style
    fields). Raises ValueError with the offending line number on bad rows."""
    items: list[dict[str, Any]] = []
    jsonl = path.lower().endswith(".jsonl")
    with open(path, encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or (not jsonl and line.startswith("#")):
                continue
            if jsonl:
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(f"{path}:{lineno}: bad JSON: {e}")
                if not isinstance(obj, dict):
                    raise ValueError(
                        f"{path}:{lineno}: expected an object, got "
                        f"{type(obj).__name__}"
                    )
                unknown = set(obj) - _ITEM_KEYS
                if unknown:
                    raise ValueError(
                        f"{path}:{lineno}: unknown keys {sorted(unknown)}; "
                        f"valid: {sorted(_ITEM_KEYS)}"
                    )
                if not str(obj.get("text", "")).strip():
                    raise ValueError(f"{path}:{lineno}: missing/empty 'text'")
                item = {**defaults, **obj}
            else:
                item = {**defaults, "text": line}
            item.setdefault("id", f"{lineno:06d}")
            item["id"] = str(item["id"])
            items.append(item)
    ids = [it["id"] for it in items]
    dup = {i for i in ids if ids.count(i) > 1}
    if dup:
        raise ValueError(f"duplicate item ids: {sorted(dup)}")
    return items


def _submit_kwargs(service, item: dict[str, Any]) -> dict[str, Any]:
    """Translate one manifest item into ``TTSService.submit`` kwargs — the
    same resolution the HTTP daemon applies (saved_voice -> library wav,
    max_seconds -> frames)."""
    kwargs: dict[str, Any] = {"text": item["text"]}
    for k in ("voice", "instruct"):
        if item.get(k):
            kwargs[k] = str(item[k])
    if item.get("speed") is not None:
        kwargs["speed"] = float(item["speed"])
    if item.get("saved_voice"):
        wav_path, transcript = service.resolve_saved_voice(
            str(item["saved_voice"])
        )
        kwargs["ref_wav_path"] = wav_path
        kwargs["ref_text"] = item.get("ref_text") or transcript or "."
    elif item.get("ref_audio"):
        kwargs["ref_wav_path"] = str(item["ref_audio"])
        kwargs["ref_text"] = item.get("ref_text") or "."
    if item.get("max_seconds") is not None:
        kwargs["max_frames"] = max(1, int(
            float(item["max_seconds"]) * service.cfg.codec.frame_rate
        ))
    return kwargs


def _run_one(service, item: dict[str, Any], out_dir: str) -> dict[str, Any]:
    """Submit one item, drain its chunk queue, write the WAV. Returns the
    manifest row. Never raises — failures become {"ok": false} rows."""
    from .audio import write_wav

    try:
        kwargs = _submit_kwargs(service, item)
    except FileNotFoundError as e:
        return {"id": item["id"], "ok": False,
                "error": f"no saved voice {e.args[0]!r}"}
    except (ValueError, OSError) as e:
        return {"id": item["id"], "ok": False, "error": str(e)}

    while True:  # intake backpressure: our own batch, so wait instead of 503
        try:
            job = service.submit(**kwargs)
            break
        except queue.Full:
            time.sleep(0.05)
        except ValueError as e:  # bad speed/empty text
            return {"id": item["id"], "ok": False, "error": str(e)}

    pieces: list[np.ndarray] = []
    ttfa = None
    while True:
        kind, payload = job.out.get()
        if kind == "chunk":
            pieces.append(payload)
        elif kind == "error":
            return {"id": item["id"], "ok": False,
                    "error": payload["message"]}
        else:  # done
            ttfa = payload.get("ttfa_s")
            break
    sr = service.cfg.codec.sample_rate
    wav = np.concatenate(pieces) if pieces else np.zeros(0, np.int16)
    wav_path = os.path.join(out_dir, f"{item['id']}.wav")
    write_wav(wav_path, wav, sr)
    row: dict[str, Any] = {
        "id": item["id"], "ok": True, "wav": os.path.basename(wav_path),
        "seconds": round(len(wav) / sr, 3),
    }
    if ttfa is not None:
        row["ttfa_s"] = round(ttfa, 3)
    return row


def _torn(path: str) -> bool:
    """Whether a crash left ``path`` ending in a partial line (the JAX
    package appends the next row to it, losing both)."""
    if not os.path.getsize(path):
        return False
    with open(path, "rb") as fh:
        fh.seek(-1, os.SEEK_END)
        return fh.read(1) != b"\n"


def run_batch(
    service,
    items: list[dict[str, Any]],
    out_dir: str,
    *,
    resume: bool = False,
    workers: int | None = None,
) -> dict[str, Any]:
    """Drive every item through the service concurrently; returns the
    summary dict. The manifest is appended row-by-row as items finish so a
    crash loses at most the in-flight items (and ``--resume`` recovers)."""
    os.makedirs(out_dir, exist_ok=True)
    manifest_path = os.path.join(out_dir, "manifest.jsonl")

    done_ids: set[str] = set()
    if resume and os.path.exists(manifest_path):
        with open(manifest_path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn last line from a crashed run
                if row.get("ok"):
                    done_ids.add(str(row["id"]))
    todo = [it for it in items if it["id"] not in done_ids]

    # enough workers to keep every engine slot busy; the intake queue
    # provides the real bound, workers just block on job.out
    if workers is None:
        workers = max(1, 2 * service.engine.B)
    t0 = time.perf_counter()
    audio_s = 0.0
    n_ok = n_fail = 0
    write_lock = threading.Lock()

    with open(manifest_path, "a", encoding="utf-8") as mf:
        if _torn(manifest_path):
            mf.write("\n")  # new rows start on a line of their own

        def one(item):
            row = _run_one(service, item, out_dir)
            with write_lock:
                mf.write(json.dumps(row) + "\n")
                mf.flush()
            return row

        if todo:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for row in pool.map(one, todo):
                    if row["ok"]:
                        n_ok += 1
                        audio_s += row.get("seconds", 0.0)
                    else:
                        n_fail += 1

    wall = time.perf_counter() - t0
    return {
        "items": len(items), "skipped": len(items) - len(todo),
        "ok": n_ok, "failed": n_fail,
        "audio_seconds": round(audio_s, 2),
        "wall_seconds": round(wall, 2),
        "aggregate_rtf": round(audio_s / wall, 2) if wall > 0 else None,
        "manifest": manifest_path,
    }


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="qwen3-tts offline batch synthesis")
    ap.add_argument("--model", default="synthetic",
                    help="checkpoint path, or 'synthetic'/'synthetic-tiny'")
    ap.add_argument("--mode", default="custom",
                    choices=["custom", "design", "base"])
    ap.add_argument("--input", required=True,
                    help=".jsonl of items, or plain text (one per line)")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--streams", type=int, default=8,
                    help="concurrent engine slots")
    ap.add_argument("--voice", default=None, help="default speaker")
    ap.add_argument("--instruct", default=None,
                    help="default emotion/style instruction")
    ap.add_argument("--speed", type=float, default=None)
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="per-item audio budget")
    ap.add_argument("--resume", action="store_true",
                    help="skip items already ok in the manifest")
    ap.add_argument("--voices-dir", default=None,
                    help="voice library directory (saved_voice lookups)")
    args = ap.parse_args(argv)

    defaults = {k: v for k, v in {
        "voice": args.voice, "instruct": args.instruct,
        "speed": args.speed, "max_seconds": args.max_seconds,
    }.items() if v is not None}
    items = parse_items(args.input, defaults)
    if not items:
        print(json.dumps({"items": 0, "error": "no input items"}))
        return 1

    from .server import TTSService, build_model, model_device

    model = build_model(args.model, args.mode, model_device())
    service = TTSService(
        model, max_streams=args.streams, voices_dir=args.voices_dir,
        queue_size=max(64, 2 * args.streams),
    ).start()
    try:
        summary = run_batch(
            service, items, args.output, resume=args.resume
        )
    finally:
        service.stop()
    print(json.dumps(summary))
    return 0 if summary["failed"] == 0 else 2


if __name__ == "__main__":
    raise SystemExit(main())
