"""The highest ``torch.cuda.max_memory_allocated()`` read after each job
of the window (the program restarts the peak at each command), in GiB."""


def read(ctx):
    peak = max((j.peak_bytes for j in ctx.all_jobs), default=0)
    return peak / 2**30 if peak > 0 else None
