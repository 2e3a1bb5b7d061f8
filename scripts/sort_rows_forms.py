#!/usr/bin/env python3
"""Variants of the row sort (``rfx_radix_sort_rows``) timed side by side on
one NVIDIA card, and another checkout's row sort beside them.

    python3 scripts/sort_rows_forms.py [--seed N] [--other DIR ...]

Each variant is ``reflexiv_tpu_torch/csrc/radix_sort.cu`` with one textual
change (``VARIANTS``; ``kernel_forms.py`` builds them, one ``nvcc`` each,
all started together). Each ``--other DIR`` (another checkout, for
example the parent commit unpacked with ``git archive``) has its
``radix_sort.cu`` built too, as the form "other DIR", and launched through
its own C interface (the row sort before the tie pass took no lead plan:
13 arguments). Every form is launched as the wrapper launches it, with
the wrapper's buffers, on these inputs (``chip_smoke.py``'s, from
``--seed``): the main path's word rows at k = 61, 81 and 95; the k = 61
rows with the poly-T sentinel in a random quarter; the k = 61 rows of the
genome with planted repeat families (``chip_smoke.REPEATS``); 2^24 rows in
runs of 100-8,000 rows, and 2^20 rows of one leading word, at W = 2, 3
and 4. Each form's result is checked equal to ``sort_rows_torch`` (a form
named "diagnostic" leaves the rows unsorted on purpose and is only
timed); then all are timed in interleaved trains of 10 calls (median of
5 trains, ``chip_smoke.trains_ms``), with each form's peak device memory
above the input over one call, and ``torch.profiler`` gives the device
time by kernel of one call of the committed form, the form without the
CTA tier and the other checkouts'. Needs a CUDA card and ``nvcc``; prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

import numpy as np
import torch

import kernel_forms

sys.path.insert(0, kernel_forms.REPO)

NETWORK = "  warp_bitonic<W, R>(tag, tl);\n"
# the first form's test, before the network, of whether the rows are
# already in order (one row, identical rows): the network runs only if not
ORDER_TEST = """  // out of order: an element after its successor in the same run
  bool disorder = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t ntag = __shfl_down_sync(kFull, tag[r], 1);
    uint64_t nt[W - 1];
#pragma unroll
    for (int c = 0; c < W - 1; ++c) {
      nt[c] = __shfl_down_sync(kFull, (unsigned long long)tl[r][c], 1);
    }
    if (r + 1 < R) {                  // lane 31's successor: lane 0 of r + 1
      const uint32_t wtag = __shfl_sync(kFull, tag[r + 1], 0);
      uint64_t wt[W - 1];
#pragma unroll
      for (int c = 0; c < W - 1; ++c) {
        wt[c] = __shfl_sync(kFull, (unsigned long long)tl[r + 1][c], 0);
      }
      if (lane == 31) {
        ntag = wtag;
#pragma unroll
        for (int c = 0; c < W - 1; ++c) nt[c] = wt[c];
      }
    } else if (lane == 31) {
      ntag = kNoRun;
    }
    if (tag[r] != kNoRun && ntag == tag[r] &&
        tie_less<W>(ntag, nt, tag[r], tl[r])) {
      disorder = true;
    }
  }
"""
NO_CTA = "CTA tier off: runs over 32 rows to step 4"
# name -> [(text in the source, replacement)]
VARIANTS = {
    "committed": [],
    NO_CTA: [("    if (len > kCtaCap) {", "    if (len > kWarpCap) {")],
    "diagnostic: no warp tie pass": [
        ("  if (span > 32) {\n    warp_ties<W, 2>",
         "  if (span > 32 && n < 0) {\n    warp_ties<W, 2>"),
        ("  } else if (span > 0) {\n    warp_ties<W, 1>",
         "  } else if (span > 0 && n < 0) {\n    warp_ties<W, 1>")],
    "network only on rows out of order": [
        (NETWORK, ORDER_TEST + "  if (__any_sync(kFull, disorder)) "
                  "warp_bitonic<W, R>(tag, tl);\n")],
    "two comparisons a step": [
        ("""        const bool take =
            keep_min != tie_less<W>(tag[r], tl[r], ptag, pt);""",
         """        const bool take = keep_min
                              ? tie_less<W>(ptag, pt, tag[r], tl[r])
                              : tie_less<W>(tag[r], tl[r], ptag, pt);""")],
    "4 warps a block": [("constexpr int kTieWarps = 8;",
                         "constexpr int kTieWarps = 4;")],
    "16 warps a block": [("constexpr int kTieWarps = 8;",
                          "constexpr int kTieWarps = 16;")],
    "three chunks": [
        ("unsigned hm[4];", "unsigned hm[4] = {0u, 0u, 0u, 0u};"),
        ("for (int c = 0; c < 4; ++c) {\n    const int64_t p = base - 32",
         "for (int c = 0; c < 3; ++c) {\n    const int64_t p = base - 32")],
    "8 blocks an SM": [
        ("__launch_bounds__(kTieWarps * 32) tie_warp_kernel",
         "__launch_bounds__(kTieWarps * 32, 8) tie_warp_kernel")],
    "256 threads a CTA": [("constexpr int kCtaThreads = 512;",
                           "constexpr int kCtaThreads = 256;")],
    "1024 threads a CTA": [("constexpr int kCtaThreads = 512;",
                            "constexpr int kCtaThreads = 1024;")],
}
PROFILED = ("committed", NO_CTA)
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# the other checkout's launcher, before the lead plan: (rows_in, keys0,
# keys1, idx0, idx1, out, hist, status, n, W, plan (host), passes, stream)
OTHER_ROWS = [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P, _I32, _P]


def build_forms(others):
    """Compile every variant (and the other checkouts' sources); returns
    {name: (rows launcher, tile launcher, takes a lead plan)}."""
    from reflexiv_tpu_torch.kernels import build

    sources = kernel_forms.variant_sources(
        os.path.join(build.CSRC_DIR, "radix_sort.cu"), VARIANTS)
    for other in others:
        with open(os.path.join(other, "reflexiv_tpu_torch", "csrc",
                               "radix_sort.cu")) as fh:
            sources[f"other {other}"] = fh.read()
    forms = {}
    for name, handle in kernel_forms.build_libraries(
            sources, "sort_rows_forms").items():
        lead = "int lead_passes" in sources[name]
        rows = kernel_forms.bind(
            handle, "rfx_radix_sort_rows",
            build._SIGNATURES["rfx_radix_sort_rows"] if lead else OTHER_ROWS)
        tile = kernel_forms.bind(handle, "rfx_radix_sort_tile", [_I32])
        forms[name] = (rows, tile, lead)
    return forms


def sorter(form, rows, last_bits):
    """A call of the form's row sort with the wrapper's buffers."""
    from reflexiv_tpu_torch.kernels import radix_sort

    launch, tile, with_lead = form
    (n, W), dev = rows.shape, rows.device
    plan, lead = radix_sort.pass_plan(W, last_bits), radix_sort.lead_plan()
    tiles = -(-n // tile(1))

    def call():
        keys = [torch.empty(n, dtype=torch.int64, device=dev)
                for _ in range(2)]
        idx = [torch.empty(n, dtype=torch.int32, device=dev)
               for _ in range(2)]
        out = torch.empty_like(rows)
        hist = torch.empty(len(plan) * 256, dtype=torch.int32, device=dev)
        status = torch.empty(tiles * 256 + 1, dtype=torch.int64, device=dev)
        head = (rows.data_ptr(), keys[0].data_ptr(), keys[1].data_ptr(),
                idx[0].data_ptr(), idx[1].data_ptr(), out.data_ptr(),
                hist.data_ptr(), status.data_ptr(), n, W)
        plans = ((lead.ctypes.data, len(lead)) if with_lead else ()) + (
            plan.ctypes.data, len(plan))
        err = launch(*head, *plans, torch._C._cuda_getCurrentRawStream(0))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def peak_bytes(fn) -> int:
    """Peak device memory above what was allocated before, over one call."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def kernel_ms(fn):
    """{kernel name: device ms} of one call, after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
            got[name] = got.get(name, 0.0) + t / 1e3
    return got


def inputs(seed, dev):
    """(label, rows, last_bits) of every input, made one at a time."""
    import chip_smoke
    from reflexiv_tpu_torch.bitpack import num_words, word_bases
    from reflexiv_tpu_torch.kernels import extract

    rng = np.random.default_rng(seed)
    genome, reads = chip_smoke.simulate(rng, chip_smoke.GENOME_BP)
    lens = torch.full((reads.shape[0],), chip_smoke.READ_LEN,
                      dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for k in chip_smoke.ROW_KS:
        W, last = num_words(k), 2 * word_bases(k)[-1]
        bases = torch.from_numpy(reads).to(dev)
        rows = extract.extract_canonical_rows(bases, lens, k=k)
        del bases
        yield f"k={k}", rows, last
        if k == chip_smoke.ROW_KS[0]:
            rows[torch.randperm(rows.shape[0], generator=g, device=dev)
                 [:rows.shape[0] // 4]] = torch.tensor(extract.sentinel(k),
                                                       device=dev)
            yield f"k={k}, sentinel in 1/4", rows, last
            del rows
            rng_rep = np.random.default_rng(seed + 10)
            bases = torch.from_numpy(chip_smoke.sample_reads(
                rng_rep, chip_smoke.plant_repeats(rng_rep, genome))).to(dev)
            rows = extract.extract_canonical_rows(bases, lens, k=k)
            del bases
            yield f"k={k}, planted repeats", rows, last
        del rows
        yield (f"W={W}, runs of 100-8,000",
               chip_smoke.mixed_runs(torch, g, chip_smoke.MIXED_RUNS_N, W,
                                     last), last)
        one = torch.randint(0, 1 << 62, (1 << 20, W), generator=g,
                            device=dev)
        one[:, 0] = 12345
        one[:, -1] &= (1 << last) - 1
        yield f"W={W}, one run of 2^20", one, last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout, built as 'other DIR'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from reflexiv_tpu_torch.kernels import radix_sort

    print(kernel_forms.card_line(), flush=True)
    forms = build_forms(args.other)
    dev = torch.device("cuda:0")
    for label, rows, last in inputs(args.seed, dev):
        fns = {name: sorter(f, rows, last) for name, f in forms.items()}
        want = radix_sort.sort_rows_torch(rows)
        for name, fn in fns.items():
            if not name.startswith("diagnostic") and \
                    not torch.equal(fn(), want):
                raise SystemExit(f"{label}: {name!r} != sort_rows_torch")
        del want
        peaks = {name: peak_bytes(fn) for name, fn in fns.items()}
        ms = chip_smoke.trains_ms(torch, fns, calls=10)
        print(f"{label} ({rows.shape[0]} rows): equal; ms per call (median "
              "of 5 trains of 10), peak bytes: " + "; ".join(
                  f"{name} {t:.4f} ms {peaks[name]} B"
                  for name, t in ms.items()), flush=True)
        for name in fns:
            if name in PROFILED or name.startswith("other"):
                print(f"  {name}: " + ", ".join(
                    f"{kn} {t:.3f}" for kn, t in kernel_ms(fns[name]).items()),
                    flush=True)
        del rows, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
