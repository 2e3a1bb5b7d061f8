"""The share of the extension loop in which the card is busy, in %: device
activity (any kernel, copy or fill) inside the program's own
``run/extension`` ranges on the profiler's clock, over those ranges'
length, summed over the window's jobs. With ``extension_s`` and
``extension_rounds`` it gives the loop's device and host time a round."""
from benchlib.spans import busy_pct


def read(ctx):
    return busy_pct(ctx.trace, "run/extension")
