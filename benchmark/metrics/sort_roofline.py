"""The count's sort kernels' share of their roofline, in %.

Least time: every window's key (the fewest 64-bit words that hold 2k
bits) read once and written once, over the card's memory bandwidth.
Counted from the job's input shapes, whatever implements the sort. Device
time: every trace operation named as one of the sort's kernels below,
summed over the window's jobs."""

# demangled names of the kernels of the port's radix sort (csrc/radix_sort.cu)
KERNELS = (r"(?:^|[\s:])(histogram_kernel|scan_kernel|onesweep_kernel"
           r"|tie_warp_kernel|tie_cta_kernel|fill_kernel|compact_kernel)[<(]")


def least_bytes(shapes):
    return 2 * shapes["windows"] * shapes["key_words"] * 8


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    device_s = ctx.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    least_s = len(ctx.jobs) * least_bytes(ctx.shapes) / ctx.peaks.HBM_BYTES_S
    return 100.0 * least_s / device_s
