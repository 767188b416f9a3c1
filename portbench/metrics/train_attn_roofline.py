"""K1-K3's share of their roofline in the traced steps: the least time
the card could take for the launches traced (work/attention.py, at the
step's attention shapes), over the device time of the kernels that
kernels/*.json of set ``train_attention`` attribute to attention. An
entry of the set that matches no kernel fails the run."""


def read(ctx):
    bound = took = 0.0
    for entry, ops in ctx.matched("train_attention"):
        per_launch = ctx.work.bound_s(ctx.work.WORK[entry["work"]](
            **ctx.run["attention"]))
        bound += per_launch * len(ops)
        took += sum(b - a for _, a, b in ops)
    return 100.0 * bound / took
