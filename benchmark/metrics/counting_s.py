"""Mean per job of the ``run/counting`` lap in the job's ``metrics.json``:
the count (extraction, sort, coverage band),
host clock after a device synchronize."""


def read(ctx):
    return ctx.mean_lap("run/counting")
