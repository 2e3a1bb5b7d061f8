#!/usr/bin/env python3
"""Variants of the extraction kernel timed side by side on one NVIDIA card.

    python3 scripts/extract_forms.py [--seed N]

Each variant is ``reflexiv_tpu_torch/csrc/extract_kmers.cu`` with one
textual change (``VARIANTS``), compiled by its own ``nvcc`` into a library
under ``build/extract_forms/``, launched with the wrapper's geometry on
``chip_smoke.py``'s main-path read matrix (k = 31, 61, 81, 95), checked
equal to the committed kernel's output, and timed in interleaved trains of
20 calls (median of 5 trains, ``chip_smoke.trains_ms``). Needs a CUDA card
and ``nvcc``; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> [(text in the source, replacement)]
VARIANTS = {
    "committed": [],
    "warp runs from the CTA's first window": [
        ("const int lead = (int)(first_window & 31);", "const int lead = 0;")],
    "at least 6 CTAs per SM (40 registers)": [
        ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 6)")],
    "at least 8 CTAs per SM (32 registers)": [
        ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)")],
    "write-back stores": [("__stcs(", "__stwb(")],
    "cached loads": [("return __ldcs(reinterpret_cast<const uint4*>(p));",
                      "return __ldg(reinterpret_cast<const uint4*>(p));")],
}


def build_variants():
    """Compile every variant, all nvcc processes started together; returns
    {name: loaded library}."""
    from reflexiv_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, "extract_kmers.cu")) as fh:
        source = fh.read()
    out_dir = os.path.join(REPO, "build", "extract_forms")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"form{i}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        lib = os.path.join(out_dir, f"libform{i}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", src, "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        handle = ctypes.CDLL(lib)
        for fn in ("rfx_extract_canonical_keys", "rfx_extract_canonical_rows"):
            getattr(handle, fn).argtypes = build._SIGNATURES[fn]
            getattr(handle, fn).restype = ctypes.c_int
        libs[name] = handle
    return libs


def extractor(handle, bases, lens, k):
    """A call of ``handle``'s launcher with the wrapper's geometry."""
    from reflexiv_tpu_torch.bitpack import num_words
    from reflexiv_tpu_torch.kernels import extract

    R, L = bases.shape
    W = num_words(k)
    geo = extract.launch_geometry(L, k)
    fn = getattr(handle, "rfx_extract_canonical_keys" if W == 1
                 else "rfx_extract_canonical_rows")

    def call():
        out = torch.empty((R * (L - k + 1),) + ((W,) if W > 1 else ()),
                          dtype=torch.int64, device=bases.device)
        err = fn(bases.data_ptr(), lens.data_ptr(), out.data_ptr(), R, L, k,
                 0, 0, geo.reads, geo.windows, geo.smem_bytes,
                 torch._C._cuda_getCurrentRawStream(0))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build_variants()
    dev = torch.device("cuda:0")
    _genome, reads = chip_smoke.simulate(np.random.default_rng(args.seed),
                                         chip_smoke.GENOME_BP)
    bases = torch.from_numpy(reads).to(dev)
    lens = torch.full((reads.shape[0],), chip_smoke.READ_LEN,
                      dtype=torch.int32, device=dev)
    del reads
    for k in (31,) + chip_smoke.ROW_KS:
        fns = {name: extractor(h, bases, lens, k) for name, h in libs.items()}
        want = fns["committed"]()
        for name, fn in fns.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"k={k}: {name!r} != the committed kernel")
        del want
        ms = chip_smoke.trains_ms(torch, fns, calls=20)
        print(f"k={k}: equal; ms per call (median of 5 trains of 20): "
              + "; ".join(f"{name} {t:.4f}" for name, t in ms.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
