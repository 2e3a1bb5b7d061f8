"""Assembly parameters (same fields and defaults as ``reflexiv_tpu.params``).

Equivalent of the reference's parameter system
(``util/DefaultParam.java:42-292`` and ``util/Parameter.java:68-104``): a single
frozen dataclass holding every tunable, with the same defaults as the reference.

Notes on derived values (mirroring ``DefaultParam.java``):
  * ``sub_k`` = k - 1                       (``DefaultParam.java:75``)
  * ``min_error_coverage`` defaults to 4 * the *default* ``min_kmer_coverage``
    (= 8), and is NOT re-derived when ``-cover`` is changed — the reference
    keeps the constructed value (``DefaultParam.java:106``; the re-derivation
    at ``Parameter.java:482`` is commented out).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


DEFAULT_KLIST: Tuple[int, ...] = (23, 31, 41, 53, 67, 81, 95)  # DefaultParam.java:87


@dataclasses.dataclass(frozen=True)
class Params:
    """All assembly tunables. Defaults match ``util/DefaultParam.java``."""

    # k-mer geometry
    k: int = 31                       # DefaultParam.java:74
    klist: Tuple[int, ...] = DEFAULT_KLIST

    # coverage filters
    min_kmer_coverage: int = 2        # DefaultParam.java:104
    max_kmer_coverage: int = 10_000_000   # DefaultParam.java:105
    min_error_coverage: int = 8       # DefaultParam.java:106 (4 * default cover)

    # contig output
    min_contig: int = 500             # DefaultParam.java:108

    # bubble/fork removal
    bubble: bool = True               # DefaultParam.java:109

    # iteration schedule
    max_iterations: int = 150         # DefaultParam.java:115
    min_iterations: int = 15          # DefaultParam.java:116

    # read clipping / filtering
    front_clip: int = 0               # DefaultParam.java:120
    end_clip: int = 0                 # DefaultParam.java:121
    min_read_length: int = 0          # -minlength (DefaultParam.java:103;
                                      # parsed but unused in the reference —
                                      # here: reads shorter are dropped)
    read_limit: int = 0               # -reads (DefaultParam.java:72,
                                      # readLimit): stop after N input reads;
                                      # 0 = unlimited
    trust_quality: int = 0            # -trustqual: phred floor above which
                                      # a base is never error-corrected
                                      # (lighter's quality signal; 0 = off)
    kmer_overlap: int = 0             # -overlap (DefaultParam.java:102;
                                      # parsed but unused by any reference
                                      # pipeline — kept for CLI parity, 0 =
                                      # the k-1 default)
    stitch_kmer: bool = True          # -stitch disables stitch k-mer use
                                      # (Parameter.java STITCH option)

    # IO
    input_fastq: Optional[str] = None
    input_fasta: Optional[str] = None
    input_kmer: Optional[str] = None   # pre-counted k-mers (-kmerc)
    input_contig: Optional[str] = None  # fragments for reassembly (-frag)
    output_path: Optional[str] = None
    gzip_output: bool = False

    # execution
    partitions: int = 0               # -partition: >1 forces chunked
                                      # streaming counting (memory bound)
    shuffle_partitions: int = 0       # -partitionredu (Spark shuffle width;
                                      # informational here)
    cache: bool = False
    sensitive: bool = False           # -accurate: enables mercy k-mers
    interleaved: bool = False         # -inter: consecutive records are mates
    input_format: str = "auto"        # -infmt (DefaultParam.java:70: 4mc/
                                      # gzip/bzip; here: loaders sniff by
                                      # extension, value informational)
    patch: bool = False               # -patch: read-pair contig connection
                                      # stage (reference ships it disabled,
                                      # Pipelines.java:1203-1229)
    scaffold: bool = False            # -scaffold: also execute overlap-less
                                      # supported links as N-gap scaffolds
                                      # (implies -patch)
    mode: str = ""                    # -mode (free-form string in the
                                      # reference; informational)

    @property
    def sub_k(self) -> int:
        """Sub-kmer size (k-1), the sort key width. DefaultParam.java:75."""
        return self.k - 1

    def min_error_for_k(self, k: int) -> int:
        """k-dependent error-coverage threshold used by the dynamic ladder:
        the reference drops ``minErrorCoverage`` to 3x the configured cover
        for k >= 61 before sorting that k (``Pipelines.java:1413-1417``)."""
        if k >= 61:
            return 3 * self.min_kmer_coverage
        return self.min_error_coverage

    def with_cover(self, cover: int) -> "Params":
        return dataclasses.replace(self, min_kmer_coverage=cover)

    def validate(self) -> None:
        if not (3 <= self.k <= 99):
            raise ValueError(f"k={self.k} out of supported range [3, 99]")
        if self.min_kmer_coverage < 1:
            raise ValueError("min_kmer_coverage must be >= 1")
