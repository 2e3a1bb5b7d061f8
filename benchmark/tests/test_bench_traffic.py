"""The traffic generator: deterministic for a seed, and a frozen copy of
the repository's ``chip_smoke`` reads and repeat families."""
import numpy as np
import pytest

import chip_smoke
from benchlib import traffic


@pytest.mark.parametrize("block", [traffic.ROW_BLOCK, 977])
def test_reads_are_chip_smokes(monkeypatch, block):
    monkeypatch.setattr(traffic, "ROW_BLOCK", block)
    genome = np.random.default_rng(3).integers(0, 4, 50_000, dtype=np.uint8)
    want = chip_smoke.sample_reads(np.random.default_rng(11), genome)
    got = traffic.sample_reads(
        np.random.default_rng(11), genome, read_len=chip_smoke.READ_LEN,
        depth=chip_smoke.DEPTH, error_rate=chip_smoke.ERR)
    assert np.array_equal(got, want)


def test_repeats_are_chip_smokes():
    genome = np.random.default_rng(4).integers(0, 4, 1_400_000,
                                               dtype=np.uint8)
    want = chip_smoke.plant_repeats(np.random.default_rng(12), genome)
    got = traffic.plant_repeats(np.random.default_rng(12), genome,
                                chip_smoke.REPEATS, chip_smoke.REPEAT_DIV)
    assert np.array_equal(got, want)
    assert not np.array_equal(got, genome)


def test_input_is_deterministic_for_a_seed(tmp_path):
    config = {"genome_bp": 30_000, "read_len": 150,
              "repeats": [[3, 1000]], "repeat_div": 0.002}
    mix = {"depth": 20, "error_rate": 0.005, "gzip_level": 1}
    a, b, c = (str(tmp_path / n) for n in "abc")
    shape = traffic.make_input(a, config, mix, 2**40 + 5)
    assert traffic.make_input(b, config, mix, 2**40 + 5) == shape
    traffic.make_input(c, config, mix, 2**40 + 6)
    raw = [open(p, "rb").read() for p in (a, b, c)]
    assert raw[0] == raw[1] and raw[0] != raw[2]
    assert shape["reads"] == 20 * 30_000 // 150
    assert shape["bases"] == shape["reads"] * 150


def test_gzip_members_read_back(tmp_path, monkeypatch):
    """Several gzip members (as the writer makes at full size) read back as
    one file, through the reference's reader and the program's."""
    from reference.fastq import read_fastq_codes
    from reflexiv_tpu_torch.io import load_reads

    monkeypatch.setattr(traffic, "GZIP_MEMBER_BYTES", 4096)
    reads = np.random.default_rng(1).integers(0, 4, (500, 100),
                                              dtype=np.uint8)
    path = str(tmp_path / "r.fq.gz")
    traffic.write_fastq_gz(path, reads, level=1, threads=3)
    assert np.array_equal(read_fastq_codes(path), reads)
    mat, lens = load_reads(path)
    assert np.array_equal(mat, reads) and (lens == 100).all()
