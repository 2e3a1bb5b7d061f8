"""Contig merger: drop contigs contained in longer ones on either strand
(``reflexiv_tpu.merger``; ``ReflexivDSMerger.java``,
``DSMergeReverseComplementaryContigs:886``,
``DSMergeRedundantNonRCContigs:452``). Host string work: the containment
dedup of ``meta`` (:func:`reflexiv_tpu_torch.meta.dedup_contigs`)."""
from __future__ import annotations

import logging
import os
from typing import List

from .params import Params

log = logging.getLogger("reflexiv_tpu_torch")


def merge_contigs(contigs: List[str]) -> List[str]:
    from .meta import dedup_contigs

    return dedup_contigs(contigs)


def merge_contigs_cmd(params: Params) -> None:
    """The ``merger`` command: ``-fasta``/``-frag`` contigs ->
    ``Merged/part-00000`` with ``>Contig-<len>-<i>`` headers and
    ``_SUCCESS``."""
    from .io import (expand_paths, iter_fasta, write_contigs_fasta,
                     write_success_marker)

    pattern = params.input_fasta or params.input_contig
    if not pattern:
        raise SystemExit("error: merger requires -fasta contig input")
    contigs = [s.decode() for _, s in iter_fasta(expand_paths(pattern))]
    merged = merge_contigs(contigs)
    out_dir = os.path.join(params.output_path, "Merged")
    write_contigs_fasta(os.path.join(out_dir, "part-00000"),
                        [(f">Contig-{len(s)}-{i}", s)
                         for i, s in enumerate(merged)],
                        gzip_output=params.gzip_output)
    write_success_marker(out_dir)
    log.info("merger: %d -> %d contigs", len(contigs), len(merged))
