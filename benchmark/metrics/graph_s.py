"""Mean per job of the ``run/graph`` lap in the job's ``metrics.json``:
the graph (both strands, two fork-filter passes),
host clock after a device synchronize."""


def read(ctx):
    return ctx.mean_lap("run/graph")
