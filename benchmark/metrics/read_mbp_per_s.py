"""Read bases assembled per second: the read bases of the window's
completed jobs over the window's seconds (host clock, first job's start
to last job's end)."""


def read(ctx):
    if not ctx.jobs or ctx.window_s <= 0:
        return None
    return len(ctx.jobs) * ctx.shapes["bases"] / 1e6 / ctx.window_s
