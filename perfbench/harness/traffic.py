"""The one traffic generator: closed-loop clients from a mix's parameters.

A mix file (``perfbench/traffic/<name>.json``) gives the clients, the
range of frame budgets, the text length per frame, the share of requests
with an instruct and the instruct texts. Every seed gets the same work:
each round (one request of every client) holds the same multiset of
budgets (log-uniform quantiles of the range), text lengths (quantiles of
the jitter), voices (the configuration's speakers in turn) and instructs
(the share, the texts in turn), paired alike for every seed; the seed
only deals the requests to the clients, and draws the words.
"""

from __future__ import annotations

import math

import numpy as np

WORDS = (
    "the of and to in is was he for it with as his on be at by had are but "
    "from or have an they which one you were her all she there would their "
    "we him been has when who will more no if out so said what up its about "
    "into than them can only other new some could time these two may then "
    "do first any my now such like our over man me even most made after "
    "also did many before must through back years where much your way well "
    "down should because each just those people how too little state good "
    "very make world still own see men work long get here between both life "
    "being under never day same another know while last might us great old "
    "year off come since against go came right used take three morning river "
    "garden window letter summer evening village station mountain quiet "
    "bright gentle story music journey harbor lantern meadow silver thunder "
    "forest candle voice answer question window paper market kitchen"
).split()


def _quantiles(n: int, rng: np.random.Generator) -> np.ndarray:
    """(i + 0.5) / n for i < n, in an order drawn from ``rng``."""
    return (rng.permutation(n) + 0.5) / n


def _text(n_chars: int, rng: np.random.Generator) -> str:
    words = []
    size = 0
    while size < n_chars:
        w = WORDS[int(rng.integers(len(WORDS)))]
        words.append(w)
        size += len(w) + 1
    text = " ".join(words)[:max(1, n_chars - 1)]
    if text.endswith(" "):
        text = text[:-1] + "s"
    return text[0].upper() + text[1:] + "."


def generate(mix: dict, speakers: list[str], seed: int) -> list[list[dict]]:
    """Per client, its requests in order: ``text``, ``voice``,
    ``instruct`` (None or a text) and ``frames`` (the budget)."""
    rng = np.random.default_rng(int(seed))
    n = mix["clients"]
    lo, hi = mix["frames"]
    n_instruct = int(round(mix["instruct_share"] * n))
    first = mix.get("first_frames_min")
    clients: list[list[dict]] = [[] for _ in range(n)]
    for r in range(mix["rounds"]):
        # the round's requests, paired the same way for every seed ...
        fixed = np.random.default_rng(r)
        q = _quantiles(n, fixed)
        budgets = np.rint(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo))))
        jitter = 1.0 + mix["chars_jitter"] * (2.0 * _quantiles(n, fixed) - 1.0)
        stagger = _quantiles(n, fixed)
        voices = [speakers[i % len(speakers)] for i in range(n)]
        with_instruct = fixed.permutation(n) < n_instruct
        # ... and dealt to the clients in an order drawn from the seed
        for c, i in enumerate(rng.permutation(n)):
            frames = int(budgets[i])
            if r == 0 and first is not None:
                frames = first + int(stagger[i] * (frames - first + 1))
            chars = min(mix["max_chars"],
                        max(8, int(round(mix["chars_per_frame"] * frames
                                         * jitter[i]))))
            instruct = None
            if with_instruct[i]:
                texts = mix["instructs"]
                instruct = texts[(r * n + i) % len(texts)]
            clients[c].append({"text": _text(chars, rng), "voice": voices[i],
                               "instruct": instruct, "frames": frames})
    return clients
