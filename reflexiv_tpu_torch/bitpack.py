"""2-bit nucleotide packing on int64 (PyTorch counterpart of ``reflexiv_tpu.bitpack``).

A k-mer is ``W = ceil(k/31)`` int64 words. Word w holds bases
``[31w, min(31w + 31, k))`` as the integer ``sum(base[j] << 2*(n-1-j))``
over its n bases, first base in the most-significant bits. So every word
is a non-negative integer of at most 62 bits, and lexicographic order over
the words equals the reference's 2-bit lexicographic base order
(``ReflexivDSMain.java:3950-4023``). For k <= 31 (one word) a key is a
plain ``(...,)`` int64 tensor, as the ``run`` path uses it; for k >= 32 the
words are a trailing axis, ``(..., W)``.

The JAX package stores the same k-mer as ``ceil(k/16)`` big-endian uint32
limbs of one 2k-bit integer; :func:`limbs_from_keys` /
:func:`keys_from_limbs` convert between the two layouts row for row, which
is how count tables cross packages.

Base codes: A=0, C=1, G=2, T=3; any other letter (incl. N) maps to T=3,
matching ``nucleotideValue`` (``ReflexivDSMain.java:4010-4022``).
:func:`revcomp_matrix` and :func:`rolling_window_values` are the JAX
module's numpy helpers, which patching's numpy oracle uses.

torch has no ``<`` or ``<<`` on ``torch.uint32`` on the CPU, so every value
here is a non-negative int64, and 32-bit arithmetic masks with
``& 0xFFFFFFFF`` after each multiply and left shift.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

MAX_K = 99          # Params.validate's bound
RUN_MAX_K = 31      # one-word keys: the single-k ``run`` path
BASES_PER_WORD = 31  # 62 bits: every word is a non-negative int64
MASK32 = 0xFFFFFFFF
ABOVE_WORD = 1 << 62  # above every 62-bit word

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


def revcomp_matrix(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-row reverse complement of a padded (R, L) uint8 code matrix
    (host-side, numpy): one gather mapping column j -> lens-1-j, pad 0."""
    R, L = mat.shape
    col = lens[:, None].astype(np.int64) - 1 - np.arange(L)[None, :]
    ok = col >= 0
    return np.where(
        ok, 3 - mat[np.arange(R)[:, None], np.clip(col, 0, L - 1)], 0
    ).astype(np.uint8)


def rolling_window_values(mat: np.ndarray, k: int, *, want_rc: bool = True):
    """(R, L) uint8 code matrix -> (R, L-k+1) uint64 window values
    (host-side, numpy), optionally with the reverse-complement values.

    The forward value of window ``mat[i, j:j+k]`` is MSB-first
    (``sum(base[t] << 2*(k-1-t))``); the rc value is the forward value of
    the window's reverse complement. Rolled along the window axis with
    (R,)-sized carry state."""
    R, L = mat.shape
    W = L - k + 1
    if W <= 0:
        z = np.zeros((R, 0), np.uint64)
        return (z, z.copy()) if want_rc else (z, None)
    mask = np.uint64((1 << (2 * k)) - 1)
    top = np.uint64(2 * (k - 1))
    two, three = np.uint64(2), np.uint64(3)
    fwd = np.empty((R, W), np.uint64)
    rc = np.empty((R, W), np.uint64) if want_rc else None
    cur = np.zeros(R, np.uint64)
    curr = np.zeros(R, np.uint64) if want_rc else None
    for t in range(k - 1):
        c = mat[:, t].astype(np.uint64)
        cur = ((cur << two) | c) & mask
        if want_rc:
            curr = (curr >> two) | ((three ^ c) << top)
    for j in range(W):
        c = mat[:, j + k - 1].astype(np.uint64)
        cur = ((cur << two) | c) & mask
        fwd[:, j] = cur
        if want_rc:
            curr = (curr >> two) | ((three ^ c) << top)
            rc[:, j] = curr
    return fwd, rc


def check_k(k: int, max_k: int = MAX_K) -> None:
    if not 1 <= k <= max_k:
        raise ValueError(
            f"k={k}: the torch port supports 1 <= k <= {max_k} here")


def num_words(k: int) -> int:
    """Number of int64 words of a k-base key."""
    return (k + BASES_PER_WORD - 1) // BASES_PER_WORD


def word_bases(k: int) -> List[int]:
    """Bases held by each word of a k-base key (31, ..., 31, rest)."""
    return [min(BASES_PER_WORD, k - BASES_PER_WORD * w)
            for w in range(num_words(k))]


def num_limbs(k: int) -> int:
    """Number of uint32 limbs the JAX package uses for a k-base word."""
    return (k + 15) // 16


def poly_t(k: int) -> Union[int, List[int]]:
    """The poly-T key: every bit of every word's 2n bits set. It is never
    canonical (its reverse complement poly-A is smaller), so counting uses
    it as the invalid-window sentinel; it sorts last."""
    words = [(1 << (2 * n)) - 1 for n in word_bases(k)]
    return words[0] if len(words) == 1 else words


def group_sentinel(width: int) -> Union[int, List[int]]:
    """Key of a dead row among ``width``-base group keys, ordered as the
    JAX package's all-ones limbs are: above every live key, and equal to
    poly-T's key where the key fills its limbs exactly (width a multiple
    of 16: ``2 * width`` bits in ``width / 16`` limbs), as there. One word
    (width <= 31): 2^32 - 1 up to width 16, 2^60 up to 30 (room for a
    2-bit marker below 2^62, see ``packed.derive_keys_packed``), 2^62 at
    31. Several words: poly-T's words, or a first word above every word."""
    if not 1 <= width <= MAX_K:
        raise ValueError(f"group key width {width} outside [1, {MAX_K}]")
    if width <= 16:
        return MASK32
    if width <= 30:
        return 1 << 60
    if width == BASES_PER_WORD:
        return ABOVE_WORD
    if width % 16 == 0:
        return poly_t(width)
    return [ABOVE_WORD] + [0] * (num_words(width) - 1)


def where_live(live: torch.Tensor, keys: torch.Tensor, sentinel) -> torch.Tensor:
    """``keys`` (``(N,)`` or ``(N, W)``) where ``live``, else the sentinel
    (an int or a list of W words)."""
    sent = torch.tensor(sentinel, dtype=torch.int64, device=keys.device)
    return torch.where(live[:, None] if keys.dim() == 2 else live, keys, sent)


# --- int64 keys ----------------------------------------------------------------------

def _pack_word(bases: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    out = torch.zeros(bases.shape[:-1], dtype=torch.int64, device=bases.device)
    for j in range(n):
        out |= bases[..., lo + j].to(torch.int64) << (2 * (n - 1 - j))
    return out


def pack_bases(bases: torch.Tensor, k: int) -> torch.Tensor:
    """``(..., k)`` uint8 codes -> ``(...,)`` int64 keys (k <= 31) or
    ``(..., W)`` int64 words (k >= 32)."""
    check_k(k)
    sizes = word_bases(k)
    if len(sizes) == 1:
        return _pack_word(bases, 0, k)
    return torch.stack([_pack_word(bases, BASES_PER_WORD * w, n)
                        for w, n in enumerate(sizes)], dim=-1)


def unpack_bases(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bases` -> ``(..., k)`` uint8 codes."""
    check_k(k)
    sizes = word_bases(k)
    lead = keys.shape if len(sizes) == 1 else keys.shape[:-1]
    out = torch.empty(lead + (k,), dtype=torch.uint8, device=keys.device)
    for w, n in enumerate(sizes):
        word = keys if len(sizes) == 1 else keys[..., w]
        for j in range(n):
            out[..., BASES_PER_WORD * w + j] = (word >> (2 * (n - 1 - j))) & 3
    return out


def revcomp_bases(bases: torch.Tensor) -> torch.Tensor:
    """Reverse complement on 2-bit codes: reverse order, 3 - code."""
    return (3 - bases.flip(-1)).to(bases.dtype)


def revcomp_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (via unpack/pack)."""
    return pack_bases(revcomp_bases(unpack_bases(keys, k)), k)


def canonical_keys(fwd: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """Canonical one-word k-mer = min(forward, reverse complement); ties
    take the forward key (``ReflexivDSMain.java:3998-4004``)."""
    return torch.minimum(fwd, rc)


def rows_less_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a <= b`` over the trailing word axis."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for w in range(a.shape[-1]):
        lt |= eq & (a[..., w] < b[..., w])
        eq &= a[..., w] == b[..., w]
    return lt | eq


def rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row equality of ``(N,)`` keys or ``(N, W)`` word rows."""
    eq = a == b
    return eq.all(-1) if eq.dim() == 2 else eq


def searchsorted_rows(table: torch.Tensor, query: torch.Tensor
                      ) -> torch.Tensor:
    """Leftmost insertion position of each ``(N, W)`` query row among the
    lexicographically sorted ``(U, W)`` table rows (``torch.searchsorted``
    over word rows)."""
    U = table.shape[0]
    lo = torch.zeros(query.shape[0], dtype=torch.int64, device=query.device)
    hi = torch.full_like(lo, U)
    for _ in range(max(U.bit_length(), 1)):
        active = lo < hi
        mid = ((lo + hi) >> 1).clamp(max=U - 1)
        go_right = ~rows_less_equal(query, table[mid])   # table[mid] < query
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def canonical_rows(fwd: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """Several-word :func:`canonical_keys`: the lexicographic min over the
    trailing word axis, ties taking the forward key."""
    return torch.where(rows_less_equal(fwd, rc)[..., None], fwd, rc)


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
    """``(U,)`` int64 keys or ``(U, W)`` words -> ``(U, ceil(k/16))``
    big-endian 32-bit limbs (int64 values in ``[0, 2^32)``;
    ``.numpy().astype(np.uint32)`` gives the JAX array)."""
    check_k(k)
    L = num_limbs(k)
    if num_words(k) == 1:
        cols = [(keys >> (32 * (L - 1 - i))) & MASK32 for i in range(L)]
        return torch.stack(cols, dim=-1)
    bases = unpack_bases(keys, k).to(torch.int64)
    out = torch.zeros(keys.shape[:-1] + (L,), dtype=torch.int64,
                      device=keys.device)
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        out[..., L - 1 - bitpos // 32] |= bases[..., j] << (bitpos % 32)
    return out


def keys_from_limbs(limbs, k: int) -> torch.Tensor:
    """``(U, ceil(k/16))`` big-endian uint32 limbs (numpy or tensor) ->
    ``(U,)`` int64 keys or ``(U, W)`` words on the CPU (move with
    ``.to(device)``)."""
    check_k(k)
    L = num_limbs(k)
    t = torch.from_numpy(np.asarray(limbs).astype(np.int64).reshape(-1, L))
    if num_words(k) == 1:
        out = torch.zeros(t.shape[0], dtype=torch.int64)
        for i in range(L):
            out |= t[:, i] << (32 * (L - 1 - i))
        return out
    bases = torch.empty((t.shape[0], k), dtype=torch.uint8)
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        bases[:, j] = (t[:, L - 1 - bitpos // 32] >> (bitpos % 32)) & 3
    return pack_bases(bases, k)
