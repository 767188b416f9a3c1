"""The engine's share of the card's bf16 peak over the window: the
forward model FLOPs (work/flops.py) of every request completed in it,
its prompt at its contexts and its answer fed back at theirs, per second
of the window, over the peak."""


def read(ctx):
    if not ctx.run.get("window_flops"):
        return None
    return 100.0 * ctx.run["window_flops"] / ctx.run["window_s"] \
        / ctx.peaks["bf16_flops_per_s"]
