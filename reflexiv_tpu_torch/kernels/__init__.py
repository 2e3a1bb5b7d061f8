"""Hand-written CUDA kernels of the counting path and their plain torch twins.

Each wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors, and counts its kernel launches in a module-level ``LAUNCHES``.
"""


def launch_counts() -> dict:
    """The launch counters of extraction and the sort: one word, and
    ``extract_rows<W>`` / ``sort_rows<W>`` per W."""
    from . import extract, radix_sort

    got = {"extract": extract.LAUNCHES, "sort": radix_sort.LAUNCHES}
    got.update((f"extract_rows{W}", n) for W, n in extract.ROW_LAUNCHES.items())
    got.update((f"sort_rows{W}", n) for W, n in radix_sort.ROW_LAUNCHES.items())
    return got
