"""Mean per job of the ``ingest/load`` stage in the job's ``metrics.json``:
ingest's second pass over the gzipped FASTQ (inflate again, parse, pack
two bits a base into the read matrix, whose pages are first touched
there), host clock."""


def read(ctx):
    return ctx.mean_lap("ingest/load")
