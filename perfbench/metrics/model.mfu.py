"""The work done in the window as a share of the card's peak: the FLOPs of
every frame delivered in the whole-delivery window (talker step at its
context, the 15 predictor passes, code2wav), and of the prompt and seed
frame of each request whose first audio came in it, counted from the
configuration's shapes (its family's ``flops.py``), over the window's
seconds times 989 TFLOP/s (H100 SXM, dense bf16)."""

from harness.flops import peak_ops_per_s
from harness.stats import delivery_window


def read(ctx):
    cfg, flops = ctx.config, ctx.family.flops
    startup = ctx.family.reference.startup_samples(cfg["code2wav"])
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
    seed = flops.prompt(cfg, L) + flops.seed_frame(cfg)
    total += seed * sum(1 for r in ctx.records
                        if r["t_first"] is not None and t0 < r["t_first"] <= t1)
    return 100.0 * total / span[1] / peak_ops_per_s()

