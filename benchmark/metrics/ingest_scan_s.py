"""Mean per job of the ``ingest/scan`` stage in the job's ``metrics.json``:
ingest's first pass over the gzipped FASTQ (inflate, count the records
and the longest read), host clock."""


def read(ctx):
    return ctx.mean_lap("ingest/scan")
