"""Whether what the timed path served is right: a sample of the requests it
finished, judged by the plain reference.

For each sampled request the reference (the configuration's family's
``reference.py``) works out its prompt from the text, runs the talker
teacher-forced over the prompt and every frame the program served (the
seed frame, then the rendered ones), the code predictor over each frame's
served codes, and code2wav over the rendered codes. Compared:

- ``talker_gap``: the widest gap by which a served cb0 token's reference
  logit lies below the reference's best at its position;
- ``predictor_gap``: the same over the 15 residual codes of every frame;
- ``pcm_err``: the served 16-bit PCM against the reference's, as the root
  of the summed squared difference over the root of the reference's
  summed square;
- ``talker_gap_mean``, ``predictor_gap_mean``: the same gaps, averaged
  over every served token (a cell compares them where its widest gaps do
  not tell its stated precision from the program's own 8-bit path);
- ``frames_short``: sampled requests that served fewer frames than their
  budget (none may: no greedy decode of these weights stops early).

A cell compares the numbers its ``workloads/<cell>.json`` gives limits.
A control (``reference.quant.CONTROLS``) is the reference at a lower
precision in the program's place: at each position it reads the gap of
the token that the control puts first, and its own waveform's error.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import model as ref
from reference.prompt import text_tokens
from reference.quant import CONTROLS, REFERENCE

NAMES = ("talker_gap", "predictor_gap", "talker_gap_mean",
         "predictor_gap_mean", "pcm_err", "frames_short")


def pick(records: list[dict], served: dict, t_open: float, n: int,
         seed: int) -> list[dict]:
    """``n`` finished requests, the longest first, the rest drawn from the
    seed; those finished in the window before those finished earlier."""
    done = [r for r in records if r["t_done"] is not None and r["error"] is None
            and r["job"] is not None and id(r["job"]) in served]
    if not done:
        return []
    late = [r for r in done if r["t_done"] >= t_open]
    pool = late if len(late) >= n else done
    longest = max(pool, key=lambda r: r["req"]["frames"])
    rest = [r for r in pool if r is not longest]
    rng = np.random.default_rng([int(seed), 7])
    extra = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(extra)]


def served_request(rec: dict, served: dict, seeds: dict, cfg: dict) -> dict:
    codes, _ = served[id(rec["job"])]
    seed = seeds.get(id(rec["job"]))
    req = rec["req"]
    pcm = (np.concatenate(rec["pcm"]) if rec["pcm"]
           else np.zeros(0, np.int16))
    return {"tokens": text_tokens(req["text"], req["instruct"]),
            "speaker_id": cfg["speakers"].index(req["voice"]),
            "frames": req["frames"], "codes_served": codes, "seed": seed,
            "pcm": pcm}


class Judge:
    """Sums the compared numbers over the sampled requests."""

    def __init__(self):
        self.talker = 0.0
        self.predictor = 0.0
        self.sums = {"talker": [0.0, 0], "predictor": [0.0, 0]}
        self.err2 = 0.0
        self.ref2 = 0.0
        self.short = 0
        self.bad_pcm = False

    def numbers(self) -> dict:
        err = (float("inf") if self.bad_pcm or self.ref2 == 0
               else float(np.sqrt(self.err2 / self.ref2)))
        mean = {k: (t / n if n else 0.0) for k, (t, n) in self.sums.items()}
        return {"talker_gap": self.talker, "predictor_gap": self.predictor,
                "talker_gap_mean": mean["talker"],
                "predictor_gap_mean": mean["predictor"],
                "pcm_err": err, "frames_short": self.short}

    def add(self, part: str, logits: torch.Tensor,
            chosen: torch.Tensor) -> None:
        """The gaps of the tokens ``chosen`` at ``part`` (talker or
        predictor) under the reference's ``logits``."""
        best = logits.max(dim=-1).values
        gap = best - logits.gather(-1, chosen[..., None])[..., 0]
        setattr(self, part, max(getattr(self, part), float(gap.max())))
        self.sums[part][0] += float(gap.double().sum())
        self.sums[part][1] += gap.numel()


def judge(fam, raw: dict, cfg: dict, requests: list[dict], device,
          control: str | None = None) -> tuple[dict, dict | None]:
    """(the program's numbers, the numbers of the control named
    ``control``, or None), worked out by ``fam``, the configuration's
    family's ``reference.py``."""
    w = cfg["code2wav"]
    hop = int(np.prod(w["upsample_rates"]) * np.prod(w["upsampling_ratios"]))
    startup = fam.startup_samples(w)
    prog, ctl = Judge(), Judge()
    with torch.inference_mode(), ref.no_tf32():
        R = ref.Weights(raw, REFERENCE)
        C = ref.Weights(raw, CONTROLS[control]) if control else None
        for rq in requests:
            served = rq["codes_served"]                       # [Q, N]
            n = served.shape[1] if served.ndim == 2 else 0
            if n < rq["frames"] or rq["seed"] is None:
                prog.short += 1
                continue
            codes = torch.as_tensor(
                np.concatenate([rq["seed"][:, None], served], axis=1).T,
                dtype=torch.long, device=device)               # [N + 1, Q]
            req = {"tokens": rq["tokens"], "speaker_id": rq["speaker_id"],
                   "codes": codes}
            lg0, lgd = fam.judge_tokens(R, cfg, req)
            prog.add("talker", lg0, codes[:, 0])
            prog.add("predictor", lgd, codes[:, 1:])
            wav = ref.pcm16(fam.code2wav(R, w, codes[1:].T))
            pcm = torch.as_tensor(rq["pcm"].astype(np.float32), device=device)
            if pcm.shape[0] != n * hop - startup or wav.shape != pcm.shape:
                prog.bad_pcm = True
            else:
                prog.err2 += float(((pcm - wav) ** 2).sum())
                prog.ref2 += float((wav ** 2).sum())
            if C is not None:
                c0, cd = fam.judge_tokens(C, cfg, req)
                ctl.add("talker", lg0, c0.argmax(-1))
                ctl.add("predictor", lgd, cd.argmax(-1))
                cw = ref.pcm16(fam.code2wav(C, w, codes[1:].T))
                ctl.err2 += float(((cw - wav) ** 2).sum())
                ctl.ref2 += float((wav ** 2).sum())
    return prog.numbers(), (ctl.numbers() if control else None)
