"""Mean per job of the ``count/merge`` stage in the job's ``metrics.json``:
the streamed count's merges of each pass's table into the running table
on the device, summed, host clock between device synchronizes. A job
whose count is one pass (no streaming) has no such stage, and reads
nothing."""


def read(ctx):
    return ctx.mean_lap("count/merge")
