"""Python client for the HTTP daemon (``qwen3_tts_tpu_torch.server``).

Stdlib only (urllib) plus numpy, so any Python process can talk to a
serving daemon: synthesis (buffered or streamed), the OpenAI-compatible
endpoint, the voice library, health and metrics. The JAX package's
client.py; it speaks to either package's daemon.

Example::

    from qwen3_tts_tpu_torch.client import Qwen3TTSClient
    c = Qwen3TTSClient("http://127.0.0.1:8080")
    wav = c.synthesize("hello", voice="ryan")          # WAV bytes
    for pcm in c.synthesize_stream("long text ..."):    # np.int16 chunks
        play(pcm)
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Iterator

import numpy as np

_WAV_HEADER_LEN = 44  # streamed responses lead with a 44-byte PCM header


class ClientError(Exception):
    """An HTTP error from the daemon, with the parsed error message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class Qwen3TTSClient:
    def __init__(self, base_url: str, *, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- plumbing -----------------------------------------------------------

    def _request(
        self,
        path: str,
        body: dict | None = None,
        *,
        method: str | None = None,
    ):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers={"Content-Type": "application/json"} if data else {},
            method=method or ("POST" if data is not None else "GET"),
        )
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                err = json.loads(raw).get("error", "")
                # both envelopes: {"error": "..."} and OpenAI's
                # {"error": {"message": ...}}
                msg = err.get("message") if isinstance(err, dict) else err
            except (json.JSONDecodeError, AttributeError):
                msg = raw.decode(errors="replace")
            raise ClientError(e.code, msg or str(e)) from None

    def _json(self, path: str, body: dict | None = None, **kw) -> dict:
        with self._request(path, body, **kw) as r:
            return json.loads(r.read())

    # -- health / info ------------------------------------------------------

    def health(self) -> dict:
        return self._json("/healthz")

    def models(self) -> dict:
        return self._json("/v1/models")

    def metrics_text(self) -> str:
        with self._request("/metrics") as r:
            return r.read().decode()

    # -- synthesis ----------------------------------------------------------

    def synthesize(self, text: str, **options: Any) -> bytes:
        """Buffered synthesis; returns complete WAV bytes. Options mirror
        POST /v1/synthesize: voice, instruct, speed, saved_voice,
        ref_audio_b64, ref_text, max_seconds."""
        options.pop("stream", None)  # buffered by definition
        with self._request("/v1/synthesize",
                           {"text": text, **options}) as r:
            return r.read()

    def synthesize_stream(
        self, text: str, *, chunk_samples: int = 4096, **options: Any
    ) -> Iterator[np.ndarray]:
        """Streaming synthesis; yields int16 PCM chunks as the daemon
        emits them (the 44-byte live-WAV header is consumed, not yielded).
        A trailing odd byte (torn int16) is held until its pair arrives."""
        body = {"text": text, "stream": True, **options}
        with self._request("/v1/synthesize", body) as r:
            header = r.read(_WAV_HEADER_LEN)
            if header[:4] != b"RIFF":
                raise ClientError(200, "response is not a WAV stream")
            pending = b""
            while True:
                data = r.read(2 * chunk_samples)
                if not data:
                    break
                pending += data
                usable = len(pending) - (len(pending) % 2)
                if usable:
                    yield np.frombuffer(pending[:usable], np.int16)
                    pending = pending[usable:]

    def speech(self, input: str, voice: str = "alloy",
               **options: Any) -> bytes:
        """The OpenAI-compatible surface (POST /v1/audio/speech)."""
        with self._request("/v1/audio/speech",
                           {"input": input, "voice": voice,
                            **options}) as r:
            return r.read()

    # -- voice library ------------------------------------------------------

    def list_voices(self) -> list[dict]:
        return self._json("/v1/voices")["voices"]

    def enroll_voice(
        self,
        name: str,
        wav_bytes: bytes,
        transcript: str | None = None,
        *,
        overwrite: bool = False,
    ) -> str:
        import base64

        body: dict[str, Any] = {
            "name": name,
            "audio_b64": base64.b64encode(wav_bytes).decode(),
            "overwrite": overwrite,
        }
        if transcript:
            body["transcript"] = transcript
        return self._json("/v1/voices", body)["enrolled"]

    def delete_voice(self, name: str) -> None:
        with self._request(f"/v1/voices/{name}", method="DELETE"):
            pass
