"""The step's share of the card's bf16 peak: tokens trained per second
over the window, times the model FLOPs of a token (work/flops.py), over
the peak."""


def read(ctx):
    tps = ctx.run.get("tokens_per_s")
    if not tps:
        return None
    per_token = ctx.flops.train_flops_per_token(ctx.spec, ctx.run["seq"])
    return 100.0 * tps * per_token / ctx.peaks["bf16_flops_per_s"]
