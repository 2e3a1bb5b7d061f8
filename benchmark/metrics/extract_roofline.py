"""The extraction kernels' share of their roofline, in %.

Least time: each read's bases read once (1 byte a base) and its length (4
bytes), and every window's canonical key written once (the fewest 64-bit
words that hold 2k bits, 8 bytes each), over the card's memory
bandwidth. Counted from the job's input shapes, whatever implements the
step. Device time: every trace operation named as one of the extraction
kernels below, summed over the window's jobs."""

# demangled names of the port's extraction kernels (csrc/extract_kmers.cu)
KERNELS = r"(?:^|[\s:])extract_canonical_kernel[<(]"


def least_bytes(shapes):
    return (shapes["reads"] * (shapes["read_len"] + 4)
            + shapes["windows"] * shapes["key_words"] * 8)


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    device_s = ctx.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    least_s = len(ctx.jobs) * least_bytes(ctx.shapes) / ctx.peaks.HBM_BYTES_S
    return 100.0 * least_s / device_s
