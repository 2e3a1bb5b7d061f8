"""Mean per job of the ``run/emit`` plus ``run/output`` laps in the job's
``metrics.json``: contigs spelled out, then FASTA and report written."""


def read(ctx):
    return ctx.mean_lap("run/emit", "run/output")
