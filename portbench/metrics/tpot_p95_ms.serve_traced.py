"""The 95th percentile over the requests completed in the window of a
traced run of each request's time per output token, (last token - first
token) / (tokens - 1). It is a per-layer metric and not an end-to-end
one: a tail of this closed loop spreads from run to run by more than a
bound can hold (PERF.md)."""


def read(ctx):
    return ctx.run.get("tpot_p95_ms")
