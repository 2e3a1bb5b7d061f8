#!/usr/bin/env python3
"""Device time by CUDA kernel, and host enqueue time per call, of the
port's extraction, radix sort and tile gather on one NVIDIA card, at
``chip_smoke.py``'s main-path shapes.

    python3 scripts/torch_kernel_profile.py [--seed N] [--reps N]
        [--stages 16384,4096,8192,32768]

Extraction: the k = 31 keys and the k = 61 / 81 / 95 word rows of
chip_smoke's simulated 4,641,652 bp input, once for each stage size in
``--stages`` (``extract.STAGE_BASES``, the code bytes a CTA packs; the
first is the wrapper's), each line with its reads per CTA and shared
memory; then ``fill_`` of a tensor of the output's size (the card writing
those bytes and nothing else) and ``copy_`` of it (reading and writing
them), the rates a streaming kernel can reach. Sorts: the k = 31 keys and the k = 61 / 81 / 95 word rows extracted from
chip_smoke's simulated 4,641,652 bp input. Each function is warmed up once,
then ``torch.profiler`` records ``--reps`` calls; one line per function
lists every CUDA kernel and memset it ran with its calls and mean device
microseconds per function call. Tile gathers (the kernel, and
``torch.index_select`` on the same tiles): 200 calls enqueued without a
synchronize give the host microseconds per call; the profiler gives the
device microseconds. Also the host cost of the two ways to read the current
stream that a launcher can take. Needs a CUDA card; prints the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def device_us(fn, reps: int):
    """{kernel name: (calls per fn call, device us per fn call)}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = ev.cuda_time_total
        if total > 0:
            out[ev.key] = (ev.count / reps, total / reps)
    return out


def host_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def show(name: str, kernels) -> None:
    total = sum(us for _n, us in kernels.values())
    parts = "; ".join(f"{key[:60]} x{n:g} {us:.1f} us"
                      for key, (n, us) in sorted(kernels.items(),
                                                 key=lambda kv: -kv[1][1]))
    print(f"{name}: device {total:.1f} us per call: {parts}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stages", default="16384,4096,8192,32768")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from reflexiv_tpu_torch.bitpack import num_words, word_bases
    from reflexiv_tpu_torch.kernels import build, extract, partition
    from reflexiv_tpu_torch.kernels import radix_sort
    from reflexiv_tpu_torch import probes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.lib()
    dev = torch.device("cuda:0")
    _genome, reads = chip_smoke.simulate(np.random.default_rng(args.seed),
                                         chip_smoke.GENOME_BP)
    bases = torch.from_numpy(reads).to(dev)
    lens = torch.full((reads.shape[0],), chip_smoke.READ_LEN,
                      dtype=torch.int32, device=dev)
    del reads
    default_stage = extract.STAGE_BASES
    for k in (31,) + chip_smoke.ROW_KS:
        fn = (extract.extract_canonical_keys if k <= 31
              else extract.extract_canonical_rows)
        for stage in (int(s) for s in args.stages.split(",")):
            extract.STAGE_BASES = stage
            geo = extract.launch_geometry(chip_smoke.READ_LEN, k)
            show(f"extract k={k} W={num_words(k)} stage={stage} "
                 f"({geo.reads} reads per CTA, {geo.smem_bytes} B shared)",
                 device_us(lambda: fn(bases, lens, k=k), args.reps))
        extract.STAGE_BASES = default_stage
        out = fn(bases, lens, k=k)
        show(f"fill_ of the k={k} output ({out.numel() * 8} B)",
             device_us(lambda: out.fill_(0), args.reps))
        dst = torch.empty_like(out)
        show(f"copy_ of the k={k} output ({out.numel() * 8} B each way)",
             device_us(lambda: dst.copy_(out), args.reps))
        del out, dst
    keys = extract.extract_canonical_keys(bases, lens, k=31)
    show(f"sort_keys n={keys.numel()}",
         device_us(lambda: radix_sort.sort_keys(keys, bits=62), args.reps))
    show("torch.sort", device_us(lambda: torch.sort(keys), args.reps))
    del keys
    for k in chip_smoke.ROW_KS:
        rows = extract.extract_canonical_rows(bases, lens, k=k)
        last = 2 * word_bases(k)[-1]
        show(f"sort_rows k={k} W={num_words(k)} n={rows.shape[0]}",
             device_us(lambda: radix_sort.sort_rows(rows, last_bits=last),
                       args.reps))
        del rows
    del bases, lens
    torch.cuda.empty_cache()

    print("stream query: torch.cuda.current_stream().cuda_stream host "
          f"{host_us(lambda: torch.cuda.current_stream(dev).cuda_stream):.2f}"
          " us, torch._C._cuda_getCurrentRawStream host "
          f"{host_us(lambda: torch._C._cuda_getCurrentRawStream(0)):.2f} us",
          flush=True)
    for n_src, n_tiles in ((probes.GATHER_SOURCE, probes.GATHER_TILES),
                           chip_smoke.BIG_GATHER):
        g = torch.Generator(device=dev).manual_seed(args.seed)
        src = torch.randint(0, 2**31 - 1, (n_src,), dtype=torch.int32,
                            generator=g, device=dev)
        tiles = (torch.randint(0, n_src // partition.TILE, (n_tiles,),
                               generator=g, device=dev)
                 * partition.TILE).to(torch.int32)
        rows_of_src = src.view(-1, partition.TILE)
        tile_idx = (tiles // partition.TILE).to(torch.int64)
        fns = {"tile_gather": lambda: partition.tile_gather(src, tiles,
                                                            check=False),
               "index_select": lambda: torch.index_select(rows_of_src, 0,
                                                          tile_idx)}
        for name, fn in fns.items():
            print(f"{n_tiles} tiles {name}: host {host_us(fn):.1f} us per "
                  "call enqueued", flush=True)
            show(f"{n_tiles} tiles {name}", device_us(fn, 20))
        del src, tiles, rows_of_src, tile_idx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
