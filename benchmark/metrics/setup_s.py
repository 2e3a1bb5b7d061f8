"""Process start to the first timed job: imports, CUDA, the program's
kernel library, the input made and written, one warm-up job."""


def read(ctx):
    return ctx.setup_s
