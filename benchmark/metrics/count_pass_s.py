"""Mean per job of the ``count/pass`` stage in the job's ``metrics.json``:
the streamed count's passes (each chunk's extraction, sort and run
lengths, summed), host clock between device synchronizes. A job whose
count is one pass (no streaming) has no such stage, and reads nothing."""


def read(ctx):
    return ctx.mean_lap("count/pass")
