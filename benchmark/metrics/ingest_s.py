"""Mean per job of the ``run/ingest`` lap in the job's ``metrics.json``:
ingest (reading, decoding and packing the gzipped FASTQ on the host),
host clock after a device synchronize."""


def read(ctx):
    return ctx.mean_lap("run/ingest")
