"""Shared part of the kernel-variant scripts (``extract_forms.py``,
``sort_rows_forms.py``): textual variants of one CUDA source, each
compiled by its own ``nvcc`` (all started together) into a library under
``build/<name>/``, and the card's name and power limit.

A variant is a list of (text in the source, replacement) pairs; a text
that is not in the source stops the script, so a variant never runs
unchanged code under its own name.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def variant_sources(path: str, variants: dict) -> dict:
    """{name: source text}: the file at ``path`` with each variant's edits."""
    with open(path) as fh:
        source = fh.read()
    out = {}
    for name, edits in variants.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in {path}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_libraries(sources: dict, out_name: str) -> dict:
    """Compile each source text into its own shared library, every
    ``nvcc`` started at once, with the package's flags; returns {name:
    ctypes.CDLL} (the caller binds the functions it calls)."""
    from reflexiv_tpu_torch.kernels import build

    out_dir = os.path.join(REPO, "build", out_name)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
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
        libs[name] = ctypes.CDLL(lib)
    return libs


def bind(handle, name: str, argtypes):
    """``handle``'s function ``name`` with its argument types, returning
    an int (a CUDA error code, 0 for success)."""
    fn = getattr(handle, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
