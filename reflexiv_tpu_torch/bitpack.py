"""2-bit nucleotide packing on int64 (PyTorch counterpart of ``reflexiv_tpu.bitpack``).

A k-mer (k <= 31) is one int64 key: the integer ``sum(base[j] << 2*(k-1-j))``,
first base in the most-significant bits, so integer order equals the
reference's 2-bit lexicographic order (``ReflexivDSMain.java:3950-4023``).
The JAX package stores the same integer as ``W = ceil(k/16)`` big-endian
uint32 limbs; :func:`limbs_from_keys` / :func:`keys_from_limbs` convert
between the two layouts, which is how count tables cross packages.

Base codes: A=0, C=1, G=2, T=3; any other letter (incl. N) maps to T=3,
matching ``nucleotideValue`` (``ReflexivDSMain.java:4010-4022``).

torch has no ``<`` or ``<<`` on ``torch.uint32`` on the CPU, so every value
here is a non-negative int64, and 32-bit arithmetic masks with
``& 0xFFFFFFFF`` after each multiply and left shift.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_K = 31          # 2k bits must fit a non-negative int64
MASK32 = 0xFFFFFFFF

# --- host-side ASCII <-> code tables -------------------------------------------------

_ASCII_TO_CODE = np.full(256, 3, dtype=np.uint8)  # default T, as in the reference
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _ASCII_TO_CODE[ord(_ch)] = _v
    _ASCII_TO_CODE[ord(_ch.lower())] = _v

CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_ascii(seq_bytes: np.ndarray) -> np.ndarray:
    """ASCII uint8 array -> 2-bit codes (host-side, numpy)."""
    return _ASCII_TO_CODE[seq_bytes]


def decode_to_str(codes: np.ndarray) -> str:
    """2-bit code array -> nucleotide string (host-side, numpy)."""
    return CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"k={k}: the torch port supports 1 <= k <= {MAX_K} "
            "(one int64 key per k-mer)")


def num_limbs(k: int) -> int:
    """Number of uint32 limbs the JAX package uses for a k-base word."""
    return (k + 15) // 16


def group_sentinel(width: int) -> int:
    """Key of a dead row among ``width``-base group keys, ordered as the
    JAX package's all-ones limbs are: above every live key and, when the
    key fills its single limb exactly (width 16), equal to poly-T's key as
    there. 2^60 (not INT64_MAX) leaves room for a 2-bit marker below it."""
    if not 1 <= width <= 30:
        raise ValueError(f"group key width {width} outside [1, 30]")
    return MASK32 if width <= 16 else 1 << 60


# --- int64 keys ----------------------------------------------------------------------

def pack_bases(bases: torch.Tensor, k: int) -> torch.Tensor:
    """``(..., k)`` uint8 codes -> ``(...,)`` int64 keys."""
    check_k(k)
    out = torch.zeros(bases.shape[:-1], dtype=torch.int64, device=bases.device)
    for j in range(k):
        out |= bases[..., j].to(torch.int64) << (2 * (k - 1 - j))
    return out


def unpack_bases(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bases`: ``(...,)`` int64 -> ``(..., k)`` uint8."""
    check_k(k)
    out = torch.empty(keys.shape + (k,), dtype=torch.uint8, device=keys.device)
    for j in range(k):
        out[..., j] = (keys >> (2 * (k - 1 - j))) & 3
    return out


def revcomp_bases(bases: torch.Tensor) -> torch.Tensor:
    """Reverse complement on 2-bit codes: reverse order, 3 - code."""
    return (3 - bases.flip(-1)).to(bases.dtype)


def revcomp_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (via unpack/pack)."""
    return pack_bases(revcomp_bases(unpack_bases(keys, k)), k)


def canonical_keys(fwd: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """Canonical k-mer = min(forward, reverse complement); ties take the
    forward key (``ReflexivDSMain.java:3998-4004``)."""
    return torch.minimum(fwd, rc)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for 32-bit ``x`` held in int64, split into two
    16-bit halves of ``c`` so no product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on 32-bit values held in int64 (``bitpack.mix32``)."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


# --- state converters: int64 keys <-> the JAX (U, W) uint32 limb layout --------------

def limbs_from_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """``(U,)`` int64 keys -> ``(U, W)`` big-endian 32-bit limbs (int64
    values in ``[0, 2^32)``; ``.numpy().astype(np.uint32)`` gives the JAX
    array)."""
    check_k(k)
    W = num_limbs(k)
    cols = [(keys >> (32 * (W - 1 - i))) & MASK32 for i in range(W)]
    return torch.stack(cols, dim=-1)


def keys_from_limbs(limbs, k: int) -> torch.Tensor:
    """``(U, W)`` big-endian uint32 limbs (numpy or tensor) -> ``(U,)``
    int64 keys on the CPU (move with ``.to(device)``)."""
    check_k(k)
    W = num_limbs(k)
    arr = np.asarray(limbs).astype(np.int64).reshape(-1, W)
    t = torch.from_numpy(arr)
    out = torch.zeros(t.shape[0], dtype=torch.int64)
    for i in range(W):
        out |= t[:, i] << (32 * (W - 1 - i))
    return out
