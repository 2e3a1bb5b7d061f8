"""A whole run of the harness on the CPU, past its look for a card, with
the timed path broken underneath: each fault the `run` cells can have
makes ``correct`` false, and the unbroken run is correct."""
import time

import pytest
import torch

from benchlib.runner import run_cell
from test_bench_reference import small_cell


def _unchanged_round(p, round_seed, *, k):
    return p, p.live.sum(), torch.zeros((), dtype=torch.int64)


def _half_the_reads(real):
    def count(bases, lengths, **kw):
        n = bases.shape[0] // 2
        return real(bases[:n], lengths[:n], **kw)
    return count


def _one_base_changed(real):
    def emit(groups, **kw):
        out = real(groups, **kw)
        head, seq = out[0]
        out[0] = (head, ("A" if seq[0] != "A" else "C") + seq[1:])
        return out
    return emit


@pytest.mark.parametrize("fault", [
    None, "round_returns_its_state", "half_the_reads", "a_contig_altered"])
def test_faults_make_correct_false(tmp_path, monkeypatch, fault):
    from reflexiv_tpu_torch import assembler, packed

    if fault == "round_returns_its_state":
        monkeypatch.setattr(packed, "extension_round_packed",
                            _unchanged_round)
    elif fault == "half_the_reads":
        monkeypatch.setattr(assembler, "count_kmers_auto",
                            _half_the_reads(assembler.count_kmers_auto))
    elif fault == "a_contig_altered":
        monkeypatch.setattr(assembler, "emit_contigs",
                            _one_base_changed(assembler.emit_contigs))
    cell = small_cell("run.isolate_k31.30x")
    res = run_cell(cell, seed=2**36 + 9, seconds=0.01, trace=False,
                   device="cpu", work=str(tmp_path),
                   t_start=time.perf_counter(), log=lambda msg: None)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
