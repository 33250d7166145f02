"""The work done in the window as a share of the card's peak: the FLOPs of
every frame delivered in the whole-delivery window (talker step at its
context, the 15 predictor passes, code2wav), and of the prompt and seed
frame of each request whose first audio came in it, counted from the
configuration's shapes (``harness/flops.py``), over the window's seconds
times 989 TFLOP/s (H100 SXM, dense bf16)."""

from harness import flops
from harness.stats import delivery_window


def read(ctx):
    cfg = ctx.config
    w = cfg["code2wav"]
    startup = sum(r * _prod(w["upsample_rates"][i + 1:])
                  for i, r in enumerate(w["upsample_rates"]))
    hop = ctx.hop
    inside = [(t, got) for t, _, got in ctx.recorder.collects
              if ctx.t_open <= t <= ctx.t_close]
    span = delivery_window([(t, 0.0) for t, _ in inside], ctx.t_open,
                           ctx.t_close)
    if span is None or span[1] <= 0:
        return None
    L = flops.prompt_rows(cfg)
    total = 0
    for _, got in inside[1:]:
        for _, s0, s1 in got:
            f0 = 0 if s0 <= 0 else (s0 + startup) // hop
            f1 = 0 if s1 <= 0 else (s1 + startup) // hop
            total += sum(flops.frame(cfg, L + f, f) for f in range(f0, f1))
    t0, t1 = inside[0][0], inside[-1][0]
    seed = (flops.prompt(cfg, L)
            + flops.predictor_frame(cfg["code_predictor"], w["num_quantizers"],
                                    w["codebook_size"]))
    total += seed * sum(1 for r in ctx.records
                        if r["t_first"] is not None and t0 < r["t_first"] <= t1)
    return 100.0 * total / span[1] / flops.peak_ops_per_s()


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out
