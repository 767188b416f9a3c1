"""Device milliseconds per step of the kernels launched inside the
``portbench.optimizer`` range (the benchmark's wrapper around the
port's AdamW update), over the traced steps. A range that launched no
kernel fails the run."""

from portbench.bench.trace import in_range
from portbench.generators.train_steps import OPT_RANGE


def read(ctx):
    return 1e3 * in_range(ctx.trace, OPT_RANGE) / ctx.run["traced_steps"]
