"""Mean per job of the ``run/extension`` lap in the job's ``metrics.json``:
the extension loop (rounds to the fixpoint),
host clock after a device synchronize."""


def read(ctx):
    return ctx.mean_lap("run/extension")
