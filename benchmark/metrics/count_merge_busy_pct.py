"""The share of the streamed count's merges in which the card is busy, in
%: device activity (any kernel, copy or fill) inside the program's own
``count/merge`` ranges on the profiler's clock, over those ranges' length,
summed over the window's jobs. Nothing without a trace or a merge."""
from benchlib.spans import busy_pct


def read(ctx):
    return busy_pct(ctx.trace, "count/merge")
