"""Parity: the one-pass FASTQ ingest (``ingest.FastqPass``, ``csrc/ingest.cpp``)
against the two native passes it replaces (``native._scan`` +
``rfx_load``) and the port's Python readers (``io.iter_fastq`` +
``reads_to_matrix``), one case per input. Each file is read in one pass at
the default block size and at a block of a few dozen bytes, so that
records straddle blocks (and gzip members); then the whole pattern goes
through ``io.load_reads``, against the JAX package's ``io.load_reads``,
and through ``io.load_reads_filtered``. Exact: matrices and lengths equal
byte for byte."""
import ctypes
import gzip
import random
from types import SimpleNamespace

import numpy as np
import pytest

from reflexiv_tpu import io as jio
from reflexiv_tpu_torch import ingest, metrics, native
from reflexiv_tpu_torch import io as tio

CUT = 17 * 65535   # the longest line the native reader returns whole
BLOCKS = (0, 61)   # the default block size, and a block of 61 bytes


def _seqs(seed, n, lengths, alphabet="ACGT"):
    rng = random.Random(seed)
    return ["".join(rng.choice(alphabet) for _ in range(rng.choice(lengths)))
            for _ in range(n)]


def _fastq(seqs, nl="\n"):
    return "".join(f"@r{i}{nl}{s}{nl}+{nl}{'I' * len(s)}{nl}"
                   for i, s in enumerate(seqs)).encode()


def _members(data, n):
    """``data`` gzipped as ``n`` members cut at arbitrary bytes."""
    cuts = np.linspace(0, len(data), n + 1).astype(int)
    return b"".join(gzip.compress(data[a:b])
                    for a, b in zip(cuts[:-1], cuts[1:]))


def _long_lines():
    """Sequence lines longer than the native reader's cut (twice over, and
    exactly at it, which leaves an empty line behind), one a byte short of
    it ending in CR LF, and records after each."""
    rng = random.Random(7)
    big = "".join(rng.choice("ACGT") for _ in range(2 * CUT + 12345))
    seqs = _seqs(8, 12, [50, 90])
    text = (_fastq(seqs[:3]) + b"@big\n" + big.encode() + b"\n+\nI\n"
            + _fastq(seqs[3:6]) + b"@cut\n" + big[:CUT].encode()
            + b"\n+\nI\n" + _fastq(seqs[6:9]) + b"@short\n"
            + big[:CUT - 1].encode() + b"\r\n+\r\nI\r\n" + _fastq(seqs[9:]))
    return [("long.fq.gz", gzip.compress(text, 1))]


# case: (files as (name, bytes), whether the Python readers give the same
# matrix, the -minlength / -reads filters)
CASES = {
    "gzip_members": lambda: ([("a.fq.gz", _members(
        _fastq(_seqs(1, 300, range(60, 151))), 5))], True, (0, 0)),
    "plain": lambda: ([("a.fq", _fastq(_seqs(2, 200, [100])))], True,
                      (0, 0)),
    "crlf": lambda: ([("a.fq.gz", gzip.compress(
        _fastq(_seqs(3, 150, [70, 80]), "\r\n")))], True, (0, 0)),
    "mixed_lengths": lambda: ([("a.fq.gz", gzip.compress(
        _fastq(_seqs(4, 400, range(1, 501)))))], True, (0, 0)),
    "bases": lambda: ([("a.fq.gz", gzip.compress(_fastq(_seqs(
        5, 200, [40, 95], "ACGTacgtNnRYKMSWBDHVrykmswbdhv.-"))))], True,
                      (0, 0)),
    "no_final_newline": lambda: ([
        ("a.fq", _fastq(_seqs(6, 50, [33]))[:-1]),
        ("b.fq.gz", gzip.compress(_fastq(_seqs(6, 50, [33]))[:-5])),
        ("c.fq", b"@r0\nACGTN\n+\nIIIII\n@r1\nGGTCA"),
        # its CR is kept, without the LF
        ("d.fq", b"@r0\r\nACGTN\r\n+\r\nIIIII\r\n@r1\r\nGGTCA\r")],
        False, (0, 0)),
    "empty": lambda: ([("a.fq", b""), ("b.fq.gz", gzip.compress(b""))],
                      True, (0, 0)),
    "fasta_one_line": lambda: ([("a.fa.gz", gzip.compress("".join(
        f">r{i}\n{s}\n" for i, s in enumerate(_seqs(9, 101, [64, 80])))
        .encode()))], True, (0, 0)),
    "long_line": lambda: (_long_lines(), False, (0, 0)),
    "several_files": lambda: ([
        ("a.fq.gz", _members(_fastq(_seqs(10, 90, [70, 120])), 2)),
        ("b.fq.gz", _members(_fastq(_seqs(11, 90, [70, 120])), 3)),
        ("c.fq", _fastq(_seqs(12, 90, [75]))),
        ("d.fq.gz", gzip.compress(_fastq(_seqs(13, 90, [150]))))],
        True, (0, 0)),
    "filters": lambda: ([("a.fq.gz", gzip.compress(
        _fastq(_seqs(14, 500, range(20, 121)))))], True, (60, 150)),
}


def _two_passes(path):
    lib = native._get_lib()
    n, mx = native._scan(lib, path, 0)
    codes = np.zeros((n, mx), np.uint8)
    lens = np.zeros(n, np.int32)
    got = lib.rfx_load(path.encode(), 0,
                       codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       n, mx)
    assert got == n
    return codes, lens


def _one_pass(path, block_bytes):
    got = ingest.FastqPass(ingest.lib(), path, 3, block_bytes)
    try:
        codes = np.zeros((got.reads, got.longest), np.uint8)
        lens = np.zeros(got.reads, np.int32)
        got.fill(codes, lens, 3)
        with pytest.raises(OSError):   # the fill frees the blocks' reads
            got.fill(codes, lens, 3)
    finally:
        got.close()
    return codes, lens


def _stack(parts):
    """Matrices one under another, padded to the widest (``load_reads``'
    layout of several files)."""
    width = max((m.shape[1] for m, _l in parts), default=0)
    codes = np.zeros((sum(len(l) for _m, l in parts), width), np.uint8)
    at = 0
    for m, l in parts:
        codes[at:at + len(l), :m.shape[1]] = m
        at += len(l)
    return codes, np.concatenate([l for _m, l in parts] or [[]]).astype(
        np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_pass_matches_the_two_passes(case, tmp_path):
    if ingest.lib() is None or native._get_lib() is None:
        pytest.skip("the one-pass or the native library is not available")
    files, python_equal, (minlen, limit) = CASES[case]()
    paths = []
    for name, data in files:
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    pairs = []
    for path in paths:
        want = _two_passes(path)
        pairs.append(want)
        for block in BLOCKS:
            got = _one_pass(path, block)
            np.testing.assert_array_equal(got[1], want[1], err_msg=block)
            np.testing.assert_array_equal(got[0], want[0], err_msg=block)
    if python_equal:
        want = tio.reads_to_matrix(list(tio.iter_fastq(paths)))
        if not len(want[1]):
            want = tio.reads_to_matrix(
                [s for _n, s in tio.iter_fasta(paths)])
    else:
        want = _stack(pairs)
    pattern = ",".join(paths)
    met = metrics.reset()
    got = tio.load_reads(pattern)
    ref = jio.load_reads(pattern)
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    # FASTQ mode reads every file in one pass, FASTA text too
    texts = [gzip.decompress(data) if name.endswith(".gz") else data
             for name, data in files]
    assert met.counts["ingest/one_pass_files"] == len(files)
    assert met.counts["ingest/inflated_bytes"] == sum(map(len, texts))
    if minlen:
        keep = want[1] >= minlen
        want = want[0][keep], want[1][keep]
    if limit:
        want = want[0][:limit], want[1][:limit]
    got = tio.load_reads_filtered(
        pattern, SimpleNamespace(min_read_length=minlen, read_limit=limit))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
