"""Parity: the one-pass FASTQ ingest (``ingest.FastqPass``, ``csrc/ingest.cpp``)
against the two native passes it replaces (``native._scan`` +
``rfx_load``) and the port's Python readers (``io.iter_fastq`` +
``reads_to_matrix``), one case per input. Each file is read in one pass at
the default block size and at a block of a few dozen bytes, so that
records straddle blocks (and gzip members); then the whole pattern goes
through ``io.load_reads``, against the JAX package's ``io.load_reads``,
and through ``io.load_reads_filtered``. Gzip files of several members
are read a member to a thread, and held to the two passes too: members
cut inside lines, records and CR LF pairs, with header fields, empty, or
stored with a gzip header in their text; and files whose chain of
members fails (trailing bytes, truncation, a flipped CRC), which one
thread reads again. Exact: matrices and lengths equal byte for byte."""
import torch_threads  # noqa: F401
import ctypes
import gzip
import random
import struct
import zlib
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


# ---- gzip members inflated on every thread ----

MEMBER_THREADS = 4   # enough threads for the members' path to run


def _member(data, *, level=6, fname=None, extra=None, comment=None,
            hcrc=False, mtime=0x5eedf00d):
    """One gzip member of ``data`` with the header fields given, built by
    hand (``gzip.compress`` writes none of them)."""
    flg, fields = 0, b""
    if extra is not None:
        flg |= 4
        fields += struct.pack("<H", len(extra)) + extra
    if fname is not None:
        flg |= 8
        fields += fname + b"\0"
    if comment is not None:
        flg |= 16
        fields += comment + b"\0"
    head = bytes([0x1F, 0x8B, 8, flg | (2 if hcrc else 0)]) + struct.pack(
        "<I", mtime) + bytes([0, 3]) + fields
    if hcrc:
        head += struct.pack("<H", zlib.crc32(head) & 0xFFFF)
    deflate = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = deflate.compress(data) + deflate.flush()
    return head + body + struct.pack("<II", zlib.crc32(data),
                                     len(data) & 0xFFFFFFFF)


def _cut(data, cuts, **kw):
    """``data`` as members cut at the given offsets."""
    at = [0, *cuts, len(data)]
    return b"".join(_member(data[a:b], **kw) for a, b in zip(at[:-1], at[1:]))


def _record_text(seed=20, n=400, nl="\n"):
    return _fastq(_seqs(seed, n, range(60, 151)), nl)


def _cuts_inside(text, n, where):
    """``n`` cut offsets in ``text``: inside a sequence line
    (``line``), at the start of a record's ``+`` line (``record``), or
    between a CR and its LF (``crlf``)."""
    if where == "line":
        marks = [i + 7 for i in range(len(text)) if text[i:i + 3] == b"\n@r"]
    elif where == "record":
        marks = [i + 1 for i in range(len(text)) if text[i:i + 3] == b"\n+\n"]
    else:
        marks = [i + 1 for i in range(len(text)) if text[i:i + 2] == b"\r\n"]
    step = len(marks) // (n + 1)
    return [marks[step * (j + 1)] for j in range(n)]


def _false_start_text():
    """FASTQ whose one header line holds a whole gzip member header (FEXTRA,
    no byte 0, CR or LF in it) and a final stored deflate block of 514
    bytes: a start that inflates, then fails at its trailer."""
    head = (b"\x1f\x8b\x08\x04ABCD\x02\x03" + struct.pack("<H", 261)
            + b"E" * 261)
    stored = b"\x01" + struct.pack("<HH", 514, 514 ^ 0xFFFF) + b"ACGT" * 128 \
        + b"AC"
    seqs = _seqs(21, 40, [90])
    return (_fastq(seqs[:20]) + b"@x" + head + stored + b"\nACGT\n+\nIIII\n"
            + _fastq(seqs[20:]))


def _long_line_text():
    return gzip.decompress(_long_lines()[0][1])


# case: files as (name, bytes, gzip members the chain accepts, whether
# the chain fails and one thread reads the file again, whether zlib's data
# error sends the file to the two passes)
MEMBER_CASES = {
    "one_member": lambda: [("a.fq.gz", gzip.compress(_record_text()), 0, 0,
                            0)],
    "plain": lambda: [("a.fq", _record_text(), 0, 0, 0)],
    "two_members": lambda: [("a.fq.gz", _members(_record_text(), 2), 2, 0,
                             0)],
    "300_members": lambda: [("a.fq.gz", _members(_record_text(n=900), 300),
                             300, 0, 0)],
    "cut_mid_line": lambda: [("a.fq.gz", _cut(_record_text(), _cuts_inside(
        _record_text(), 5, "line")), 6, 0, 0)],
    "cut_mid_record": lambda: [("a.fq.gz", _cut(_record_text(), _cuts_inside(
        _record_text(), 5, "record")), 6, 0, 0)],
    "cut_inside_crlf": lambda: [("a.fq.gz", _cut(
        _record_text(nl="\r\n"), _cuts_inside(_record_text(nl="\r\n"), 5,
                                              "crlf")), 6, 0, 0)],
    # cut twice inside the longest line, once at the reader's own cut
    "long_line_across_members": lambda: [("a.fq.gz", _cut(
        _long_line_text(), [_long_line_text().index(b"@big") + 500_000,
                            _long_line_text().index(b"@big") + 5 + CUT,
                            _long_line_text().index(b"@cut") + 400_000]),
        4, 0, 0)],
    "empty_member": lambda: [("a.fq.gz", _members(_record_text(), 2)
                              + gzip.compress(b"") + _members(
                                  _record_text(21), 2) + gzip.compress(b""),
                              6, 0, 0)],
    "header_fields": lambda: [("a.fq.gz", _member(
        _record_text()[:5000], fname=b"lane1.fq", extra=b"BC\x02\x00ab")
        + _member(_record_text()[5000:20000], extra=b"x" * 300,
                  comment=b"run 7", hcrc=True)
        + _member(_record_text()[20000:], fname=b"", level=1), 3, 0, 0)],
    "stored_false_start": lambda: [("a.fq.gz", _members(
        _record_text(), 2) + gzip.compress(_false_start_text(), 0)
        + _members(_record_text(22), 2), 5, 0, 0)],
    "trailing_zeros": lambda: [("a.fq.gz", _members(_record_text(), 3)
                                + bytes(64), 0, 1, 0)],
    "trailing_garbage": lambda: [("a.fq.gz", _members(_record_text(), 3)
                                  + b"not a gzip member\n", 0, 1, 0)],
    "trailing_gzip_garbage": lambda: [("a.fq.gz", _members(
        _record_text(), 3) + b"\x1f\x8b\x08\x00garbage, not deflate", 0, 1,
        1)],
    "truncated_last_member": lambda: [("a.fq.gz", _members(
        _record_text(), 3)[:-700], 0, 1, 0)],
    "flipped_crc": lambda: [("a.fq.gz", _flip(_members(_record_text(), 3),
                                              -8), 0, 1, 1)],
    "two_files": lambda: [
        ("a.fq.gz", _members(_record_text(23), 4), 4, 0, 0),
        ("b.fq.gz", _cut(_record_text(24, nl="\r\n"), _cuts_inside(
            _record_text(24, nl="\r\n"), 3, "crlf")), 4, 0, 0)],
}


def _flip(data, at):
    out = bytearray(data)
    out[at] ^= 0x01
    return bytes(out)


@pytest.mark.parametrize("case", sorted(MEMBER_CASES))
def test_members_match_the_two_passes(case, tmp_path):
    """Each file read with ``MEMBER_THREADS`` threads, at the default
    block and at 61 bytes, equals ``_scan`` + ``rfx_load``; the chain
    accepts exactly the file's members, or fails and one thread reads the
    file, or zlib's data error sends it to the two passes. Then all of the
    case's files at once through ``load_reads_native`` and its counters."""
    if ingest.lib() is None or native._get_lib() is None:
        pytest.skip("the one-pass or the native library is not available")
    files = MEMBER_CASES[case]()
    paths, wants = [], []
    for name, data, members, fell_back, two_passes in files:
        path = str(tmp_path / name)
        (tmp_path / name).write_bytes(data)
        paths.append(path)
        want = _two_passes(path)
        wants.append(want)
        text = gzip.decompress(data) if members else None
        for block in BLOCKS:
            got = ingest.FastqPass(ingest.lib(), path, MEMBER_THREADS, block)
            try:
                assert (got.members, got.fell_back, got.two_passes) == (
                    members, fell_back, bool(two_passes)), block
                assert 1 <= got.inflate_threads <= MEMBER_THREADS
                if case == "stored_false_start":
                    assert got.false_starts >= 1
                if two_passes:
                    continue
                if members:
                    assert got.inflated == len(text)
                codes = np.zeros((got.reads, got.longest), np.uint8)
                lens = np.zeros(got.reads, np.int32)
                got.fill(codes, lens, MEMBER_THREADS)
            finally:
                got.close()
            msg = f"block {block}"
            np.testing.assert_array_equal(lens, want[1], err_msg=msg)
            np.testing.assert_array_equal(codes, want[0], err_msg=msg)
    met = metrics.reset()
    got = native.load_reads_native(paths, threads=2 * MEMBER_THREADS)
    want = _stack(wants)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    counts = met.counts
    assert counts["ingest/members"] == sum(f[2] for f in files)
    assert counts["ingest/member_fallbacks"] == sum(f[3] for f in files)
    assert counts["ingest/one_pass_files"] == sum(not f[4] for f in files)
    # files read at once share the threads
    per_file = max(2, 2 * MEMBER_THREADS // len(files))
    if counts["ingest/one_pass_files"]:
        assert 1 <= counts["ingest/inflate_threads"] <= per_file
    else:
        assert counts["ingest/inflate_threads"] == 0
    if case == "stored_false_start":
        assert counts["ingest/false_member_starts"] >= 1
