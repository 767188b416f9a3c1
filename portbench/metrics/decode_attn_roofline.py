"""K4's share of its roofline in the traced stretch: the mean least time
of the decode-attention calls recorded there (work/attention.py, from
each call's live lengths), times the kernels of set ``decode_attention``
traced, over their device time. An entry of the set that matches no
kernel, or a stretch with no call recorded, fails the run."""

from portbench.bench.trace import NothingToRead


def read(ctx):
    calls = ctx.run.get("decode_calls") or []
    if not calls:
        raise NothingToRead("no decode-attention call was recorded in the "
                            "traced stretch")
    bound = took = 0.0
    for entry, ops in ctx.matched("decode_attention"):
        fn = ctx.work.WORK[entry["work"]]
        mean = sum(ctx.work.bound_s(fn(**c)) for c in calls) / len(calls)
        bound += mean * len(ops)
        took += sum(b - a for _, a, b in ops)
    return 100.0 * bound / took
