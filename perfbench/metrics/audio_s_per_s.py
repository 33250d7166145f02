"""Seconds of audio handed to the clients per second of the window.

A delivery is one engine step's collection, inside which the step's PCM
reaches every job's queue. The window runs from the first delivery after
it opens to the last before it closes, and counts the samples of the
deliveries after the first: whole steps only (``stats.delivery_window``).
Failed requests deliver nothing."""

from harness.stats import whole_delivery_rate


def read(ctx):
    sr = ctx.config["code2wav"]["sample_rate"]
    deliveries = [(t, sum(s1 - s0 for _, s0, s1 in got))
                  for t, _, got in ctx.recorder.collects]
    rate = whole_delivery_rate(deliveries, ctx.t_open, ctx.t_close)
    return None if rate is None else rate / sr
