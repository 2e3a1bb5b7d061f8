"""Command-line interface: the nine commands of ``reflexiv_tpu.cli``.

Same command names and flags as ``reflexiv_tpu/cli.py`` (the reference
launcher's, ``util/Parameter.java:68-104``), plus ``-device`` (default
``cuda``; ``cuda`` without a usable card raises, it never runs on the CPU
in its place). Every k-taking command takes 1 <= k <= 99
(``bitpack.MAX_K``); ``reduce``/``meta`` take ``-accurate`` (mercy
k-mers), ``meta`` also ``-patch``/``-scaffold`` (read-pair patching).

    python -m reflexiv_tpu_torch.cli run -fastq 'reads*.fq.gz' \
        -outfile ./result -kmer 31 -cover 3
    python -m reflexiv_tpu_torch.cli counter -fastq reads.fq.gz \
        -outfile ./out -kmer 61 -device cpu
    python -m reflexiv_tpu_torch.cli reduce -fastq reads.fq.gz \
        -outfile ./out -cover 3
    python -m reflexiv_tpu_torch.cli meta -paired m1.fq,m2.fq \
        -outfile ./out -cover 3 -accurate -patch -scaffold
    python -m reflexiv_tpu_torch.cli mercy -fastq reads.fq.gz \
        -outfile ./out -kmer 61 -cover 3
    python -m reflexiv_tpu_torch.cli preprocess -fastq m1.fq,m2.fq \
        -outfile ./pre
    python -m reflexiv_tpu_torch.cli reassembler -fastq reads.fq \
        -frag contigs.fa -outfile ./re -kmer 31
    python -m reflexiv_tpu_torch.cli merger -fasta contigs.fa -outfile ./m
    python -m reflexiv_tpu_torch.cli stitch -fastq reads.fq \
        -frag contigs.fa -outfile ./st
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from . import __version__, metrics
from .device import resolve_device
from .kernels import launch_counts
from .params import DEFAULT_KLIST, Params

log = logging.getLogger("reflexiv_tpu_torch")

COMMANDS = (
    "run", "meta", "counter", "reduce", "reassembler",
    "merger", "mercy", "preprocess", "stitch",
)
PORTED = COMMANDS


def _add_common(p: argparse.ArgumentParser) -> None:
    # input (Parameter.java:68-104 option names)
    p.add_argument("-fastq", help="input FASTQ file(s), glob/comma list")
    p.add_argument("-fasta", help="input FASTA file(s)")
    p.add_argument("-paired", help="paired FASTQ files 'mate1,mate2'")
    p.add_argument("-single", help="single-end FASTQ file(s)")
    p.add_argument("-inter", help="interleaved paired FASTQ file(s)")
    p.add_argument("-kmerc", help="counted k-mer CSV input (skip counting)")
    p.add_argument("-frag", help="pre-assembled contig/fragment FASTA")
    p.add_argument("-contig", help="input contig FASTA (alias of -frag)")
    p.add_argument("-outfile", required=True, help="output directory")
    p.add_argument("-infmt", default="auto",
                   help="input compression format (loaders sniff by "
                        "extension)")
    p.add_argument("-reads", type=int, default=0,
                   help="use only the first N input reads (0 = all)")
    # k-mer geometry
    p.add_argument("-kmer", type=int, default=31, help="k-mer size (default 31)")
    p.add_argument("-klist", default=",".join(map(str, DEFAULT_KLIST)),
                   help="comma list of k sizes for dynamic assembly")
    p.add_argument("-overlap", type=int, default=0,
                   help="overlap between adjacent k-mers (parsed, unused)")
    # coverage
    p.add_argument("-cover", type=int, default=2,
                   help="min k-mer coverage (default 2)")
    p.add_argument("-maxcov", type=int, default=10_000_000,
                   help="max k-mer coverage")
    p.add_argument("-error", type=int, default=None,
                   help="min error-correction coverage (default 4*2)")
    # contig / iteration
    p.add_argument("-mincontig", type=int, default=500,
                   help="min contig length to report")
    p.add_argument("-maxiter", type=int, default=150)
    p.add_argument("-miniter", type=int, default=15)
    p.add_argument("-bubble", dest="bubble", action="store_false",
                   default=True,
                   help="set to NOT remove bubbles: skips both fork-filter "
                        "stages")
    p.add_argument("-stitch", action="store_true",
                   help="disable stitch k-mers")
    # clipping / filtering
    p.add_argument("-clipf", type=int, default=0, help="front clip")
    p.add_argument("-clipe", type=int, default=0, help="end clip")
    p.add_argument("-minlength", type=int, default=0,
                   help="drop reads shorter than this")
    p.add_argument("-trustqual", type=int, default=0,
                   help="preprocess: never correct bases with phred >= N")
    # misc
    p.add_argument("-gzip", action="store_true", help="gzip outputs")
    p.add_argument("-accurate", action="store_true",
                   help="sensitive mode (mercy k-mers)")
    p.add_argument("-patch", action="store_true",
                   help="meta: read-pair contig connection stage")
    p.add_argument("-scaffold", action="store_true",
                   help="meta: N-gap scaffolds (implies -patch)")
    p.add_argument("-partition", type=int, default=0,
                   help="re-partition number: count the in-memory reads "
                        "in that many row chunks (the table is the same)")
    p.add_argument("-partitionredu", type=int, default=0,
                   help="shuffle partition count (informational)")
    p.add_argument("-cache", action="store_true",
                   help="cache intermediate data (informational)")
    p.add_argument("-mode", default="", help="pipeline mode string")
    p.add_argument("-sbin", default=None,
                   help="external binary dir (ignored)")
    p.add_argument("-seed", type=int, default=0,
                   help="orientation-draw seed")
    p.add_argument("-device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")


def params_from_args(args: argparse.Namespace) -> Params:
    fastq = args.fastq
    for alt in (args.paired, args.single, args.inter):
        if alt and not fastq:
            fastq = alt
    return Params(
        k=args.kmer,
        klist=tuple(int(x) for x in args.klist.split(",")),
        min_kmer_coverage=args.cover,
        max_kmer_coverage=args.maxcov,
        min_error_coverage=args.error if args.error is not None else 8,
        min_contig=args.mincontig,
        max_iterations=args.maxiter,
        min_iterations=args.miniter,
        bubble=args.bubble,
        front_clip=args.clipf,
        end_clip=args.clipe,
        min_read_length=args.minlength,
        read_limit=args.reads,
        trust_quality=args.trustqual,
        kmer_overlap=args.overlap,
        stitch_kmer=not args.stitch,
        input_fastq=fastq,
        input_fasta=args.fasta,
        input_kmer=args.kmerc,
        input_contig=args.frag or args.contig,
        output_path=args.outfile,
        gzip_output=args.gzip,
        partitions=args.partition,
        shuffle_partitions=args.partitionredu,
        cache=args.cache,
        sensitive=args.accurate,
        interleaved=bool(args.inter),
        input_format=args.infmt,
        mode=args.mode,
        patch=args.patch or args.scaffold,
        scaffold=args.scaffold,
    )


def _load_read_matrix(params: Params):
    from .io import load_reads_filtered

    pattern = _pattern(params)
    mat, lens = load_reads_filtered(pattern, params)
    if mat.shape[0] == 0:
        raise SystemExit(f"error: no reads found in {pattern}")
    return mat, lens


def _pattern(params: Params) -> str:
    pattern = params.input_fastq or params.input_fasta
    if not pattern:
        raise SystemExit("error: provide -fastq or -fasta input")
    return pattern


def cmd_counter(params: Params, seed: int, device) -> None:
    """K-mer counting only (MainOfCounter -> ReflexivDataFrameCounter);
    with ``-frag``/``-contig`` the fragments' k-mers are counted in their
    own unclipped pass and merged in. Under ``REFLEXIV_INGEST_BUDGET_MB``
    the reads are counted from disk in bounded chunks."""
    from .count import (count_kmers_auto, count_kmers_from_files,
                        merge_count_tables)
    from .io import ingest_budget_bytes
    from .kmer_io import write_count_table

    budget = ingest_budget_bytes()
    clips = dict(k=params.k, min_cov=1, max_cov=2_000_000_000,
                 front_clip=params.front_clip, end_clip=params.end_clip,
                 device=device)
    if budget:
        keys, counts = count_kmers_from_files(
            _pattern(params), params=params, budget_bytes=budget, **clips)
        width = 0
    else:
        mat, lens = _load_read_matrix(params)
        keys, counts = count_kmers_auto(
            mat, lens, partitions=params.partitions, **clips)
        width = mat.shape[1]
        del mat, lens
    if params.input_contig:
        from .io import contigs_to_segment_matrix, expand_paths, iter_fasta

        frags = [s.decode() for _name, s in
                 iter_fasta(expand_paths(params.input_contig))]
        fmat, flens = contigs_to_segment_matrix(
            frags, k=params.k, seg=max(width, 256))
        if len(flens):
            fkeys, fcounts = count_kmers_auto(
                fmat, flens, k=params.k, min_cov=1, max_cov=2_000_000_000,
                device=device)
            keys, counts = merge_count_tables(keys, counts, fkeys, fcounts)
        log.info("injected %d fragment segments into counting", len(flens))
    band = (counts >= params.min_kmer_coverage) & (
        counts <= params.max_kmer_coverage)
    keys, counts = keys[band], counts[band]
    out_dir = os.path.join(params.output_path, f"Count_{params.k}")
    path = write_count_table(out_dir, keys, counts, params.k, gzip_output=True)
    log.info("wrote %d k-mers to %s", counts.numel(), path)


def _auto_mesh(device):
    """A mesh over every card when ``device`` is ``cuda`` without an index
    and more than one card is present (``cli._auto_mesh``), else None."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or \
            torch.cuda.device_count() < 2:
        return None
    from .parallel import make_mesh

    return make_mesh([torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())])


def cmd_run(params: Params, seed: int, device, mesh=None) -> None:
    """Single-k assembly (Main -> ReflexivDSMain.assembly). Under
    ``REFLEXIV_INGEST_BUDGET_MB`` the reads are counted from disk in
    bounded chunks and the read matrix is never built. Otherwise the read
    matrix goes through :func:`parallel.assemble_reads_sharded` on
    ``mesh``, or on :func:`_auto_mesh`'s when none is given and there is
    one; ``-kmerc`` and the budget stay on one card."""
    from .assembler import assemble_from_counts, assemble_reads
    from .contigs import write_assembly_report
    from .io import (ingest_budget_bytes, write_contigs_fasta,
                     write_success_marker)
    from .kmer_io import read_count_table

    met = metrics.current()
    if params.input_kmer:
        with met.stage("run/ingest"):
            keys, counts = read_count_table(params.input_kmer, params.k)
            keep = (counts >= params.min_kmer_coverage) & (
                counts <= params.max_kmer_coverage)
        contigs = assemble_from_counts(
            keys[keep], counts[keep], params, seed=seed, device=device)
    elif ingest_budget_bytes():
        from .count import count_kmers_from_files

        with met.stage("run/counting", device=device):
            keys, counts = count_kmers_from_files(
                _pattern(params), k=params.k,
                min_cov=params.min_kmer_coverage,
                max_cov=params.max_kmer_coverage,
                front_clip=params.front_clip, end_clip=params.end_clip,
                params=params, budget_bytes=ingest_budget_bytes(),
                device=device)
        met.set("run/solid_kmers", counts.numel())
        contigs = assemble_from_counts(keys, counts, params, seed=seed,
                                       device=device)
        met.set("run/contigs", len(contigs))
    else:
        with met.stage("run/ingest"):
            mat, lens = _load_read_matrix(params)
        met.set("run/reads", mat.shape[0])
        mesh = mesh if mesh is not None else _auto_mesh(device)
        if mesh is not None:
            from .parallel import assemble_reads_sharded

            met.lap_start()   # the sharded laps run from here
            contigs = assemble_reads_sharded(mat, lens, params, mesh=mesh,
                                             seed=seed)
        else:
            contigs = assemble_reads(mat, lens, params, seed=seed,
                                     device=device)
    out = params.output_path
    with met.stage("run/output"):
        with met.stage("output/fasta"):
            write_contigs_fasta(os.path.join(out, "part-00000"), contigs,
                                gzip_output=params.gzip_output)
            write_success_marker(out)
        with met.stage("output/report"):
            stats = write_assembly_report(
                os.path.join(out, "assembly_report.txt"), contigs)
    log.info(
        "wrote %d contigs to %s (canonicalized: n=%d total=%dbp "
        "longest=%d N50=%d)", len(contigs), out, stats["n_contigs"],
        stats["total_bp"], stats["longest"], stats["n50"],
    )


def cmd_meta(params: Params, seed: int, device, mesh=None) -> None:
    """Dynamic multi-k assembly (MainMeta -> the staged dynamic pipe);
    after a ``reduce`` into the same -outfile it starts from its
    ``Count_<k>_reduced`` tables. On ``mesh``, or on :func:`_auto_mesh`'s
    when none is given and there is one, it runs the mesh path
    (:mod:`meta`)."""
    from .meta import dynamic_assembly

    mesh = mesh if mesh is not None else _auto_mesh(device)
    dynamic_assembly(params, seed=seed, device=device, mesh=mesh)


def cmd_reduce(params: Params, seed: int, device) -> None:
    """Multi-k counting + sorting + reduction (MainOfReduce)."""
    from .dynamic import dynamic_reduction

    dynamic_reduction(params, seed=seed, device=device)


def cmd_mercy(params: Params, seed: int, device) -> None:
    """Single-k assembly over the solid + mercy table (MainOfMercy)."""
    from .mercy import mercy_assembly

    mercy_assembly(params, seed=seed, device=device)


def cmd_reassembler(params: Params, seed: int, device) -> None:
    """Fragments extended through the read graph (MainOfReAssembler)."""
    from .reassemble import reassemble

    reassemble(params, seed=seed, device=device)


def cmd_merger(params: Params, seed: int, device) -> None:
    """Containment dedup of a contig set (MainOfMerger)."""
    from .merger import merge_contigs_cmd

    del seed, device   # host string work
    merge_contigs_cmd(params)


def cmd_preprocess(params: Params, seed: int, device) -> None:
    """Pair merging and k-mer-spectrum correction (MainOfPreProcessing)."""
    from .preprocess import preprocess

    del seed   # preprocessing draws nothing at random
    preprocess(params, device=device)


def cmd_stitch(params: Params, seed: int, device) -> None:
    """Contigs joined across thin gaps by read k-mers, k = 21, 31, 61."""
    from .stitch import stitch

    stitch(params, seed=seed, device=device)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="Reflexiv %(asctime)s %(message)s", datefmt="%H:%M:%S",
    )
    parser = argparse.ArgumentParser(
        prog="reflexiv-tpu-torch",
        description="De novo genome assembler, PyTorch + CUDA port "
                    f"(v{__version__}; Reflexiv method)",
    )
    parser.add_argument(
        "-version", action="version", version=f"reflexiv-tpu-torch {__version__}"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd in COMMANDS:
        _add_common(sub.add_parser(cmd))
    args = parser.parse_args(argv)
    params = params_from_args(args)
    params.validate()
    device = resolve_device(args.device)

    t0 = time.time()
    m = metrics.reset()
    handler = globals()[f"cmd_{args.command}"]
    before = launch_counts()
    if device.type == "cuda":
        torch.cuda.init()     # the allocator's stats need CUDA started
        torch.cuda.reset_peak_memory_stats(device)
    with m.stage(args.command, device=device):
        handler(params, args.seed, device)
    for name, n in launch_counts().items():
        m.set(f"launches/{name}", n - before.get(name, 0))
    if device.type == "cuda":
        # meta restarts the peak counters at every stage and keeps the
        # highest of its stages in meta/peak_bytes
        m.set("device/peak_bytes", max(torch.cuda.max_memory_allocated(device),
                                       m.counts.get("meta/peak_bytes", 0)))
    if params.output_path:
        path = m.write(params.output_path)
        log.info("metrics written to %s", path)
    log.info("%s finished in %.1f s on %s", args.command, time.time() - t0,
             device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
