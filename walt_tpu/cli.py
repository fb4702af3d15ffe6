"""Command-line drivers: ``waltx`` (mapper) and ``waltx index`` (indexer).

Flag names, defaults and validation mirror the reference CLIs
(``src/walt/walt.cpp:130-246`` and ``src/walt/makedb.cpp:93-128``) so
existing WALT invocations can be replayed verbatim, plus device-specific
extensions (backend/pattern/mesh options).
"""

from __future__ import annotations

import argparse
import os
import sys

MAX_BATCH = 100_000_000  # walt.cpp:119
FASTQ_SUFFIXES = (".fastq", ".fq")  # walt.cpp:92


def _split_filenames(csv: str):
    """Comma- or space-separated list (walt.cpp:47-55)."""
    return [s for s in csv.replace(",", " ").split() if s]


#: options that take no value (for config-file boolean lines)
_FLAG_NAMES = frozenset(
    ("a", "ambiguous", "u", "unmapped", "A", "ag-wild", "P", "pbat", "sam",
     "v", "verbose")
)


def _apply_config_file(argv):
    """``-config-file FILE`` support (OptionParser.cpp:279-344).

    The file holds ``name=value`` lines ('#' comments skipped); names are
    option names without dashes.  Command-line arguments override the file
    (the reference parses the config first, then lets argv overwrite).
    """
    argv = list(argv)
    for i, a in enumerate(argv):
        if a in ("-config-file", "--config-file"):
            if i + 1 >= len(argv):
                raise SystemExit("-config-file requires config filename")
            path = argv[i + 1]
            try:
                lines = open(path).read().splitlines()
            except OSError:
                raise SystemExit(f"cannot open config file: {path}")
            injected = []
            for ln, line in enumerate(lines, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" not in line:
                    raise SystemExit(
                        f"Line {ln} malformed in config file {path}"
                    )
                name, _, val = line.partition("=")
                name, val = name.strip(), val.strip()
                if name in _FLAG_NAMES:
                    if val.lower() in ("true", "1", "yes", "on"):
                        injected.append(f"-{name}")
                else:
                    injected += [f"-{name}", val]
            # injected first: later (command-line) occurrences win
            return injected + argv[:i] + argv[i + 2:]
    return argv


def _validate_index(index: str) -> None:
    """walt.cpp:67-85."""
    if not os.path.isfile(index):
        raise SystemExit(f"bad index file: {index}")
    for suf in ("_CT00", "_CT01", "_GA10", "_GA11"):
        if not os.path.isfile(index + suf):
            raise SystemExit(f"bad table file: {index + suf}")


def build_map_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="waltx", description="map Illumina BS-seq reads (JAX-native WALT)"
    )
    a = p.add_argument
    a("-i", "-index", "--index", dest="index", required=True,
      help="index file created by 'waltx index' or WALT makedb (.dbindex)")
    a("-r", "-reads", "--reads", dest="reads", default="",
      help="comma-sep list of single-end read files (.fastq/.fq)")
    a("-1", "-reads1", "--reads1", dest="reads1", default="",
      help="comma-sep list of mate-1 read files")
    a("-2", "-reads2", "--reads2", dest="reads2", default="",
      help="comma-sep list of mate-2 read files")
    a("-o", "-output", "--output", dest="output", required=True,
      help="output file names (comma sep)")
    a("-m", "-mismatch", "--mismatch", dest="mismatch", type=int, default=6,
      help="max allowed mismatches")
    a("-N", "-number", "--number", dest="batch", type=int, default=10_000_000,
      help="number of reads per batch")
    a("-a", "-ambiguous", "--ambiguous", dest="ambiguous", action="store_true",
      help="output one random location for ambiguously mapped reads")
    a("-u", "-unmapped", "--unmapped", dest="unmapped", action="store_true",
      help="output unmapped reads in separate file")
    a("-C", "-clip", "--clip", dest="adaptor", default="",
      help="clip the specified adaptor")
    a("-A", "-ag-wild", "--ag-wild", dest="ag_wildcard", action="store_true",
      help="map using A/G bisulfite wildcards (single-end)")
    a("-P", "-pbat", "--pbat", dest="pbat", action="store_true",
      help="reads are PBAT (post-bisulfite adaptor tagging): mate "
           "conversion roles swap (README.md:100-104 extension; the "
           "reference documents but does not implement -P)")
    a("-b", "-bucket", "--bucket", dest="bucket", type=int, default=5000,
      help="maximum candidates for a seed")
    a("-k", "-topk", "--topk", dest="top_k", type=int, default=50,
      help="maximum allowed mappings for a read (paired-end)")
    a("-L", "-fraglen", "--fraglen", dest="fraglen", type=int, default=1000,
      help="max fragment length (paired-end)")
    a("-sam", "--sam", dest="sam", action="store_true", help="output SAM format")
    a("-v", "-verbose", "--verbose", dest="verbose", action="store_true")
    a("-t", "-thread", "--thread", dest="threads", type=int, default=1,
      help="host-side worker threads for the exact fallback/oracle paths "
           "(device parallelism is the mesh; walt.cpp:165-166 analog)")
    # device extensions
    a("--backend", default="jax", choices=("jax", "numpy"),
      help="candidate enumeration backend (jax=accelerator via JAX, "
           "numpy=host oracle)")
    a("--tp", dest="tp", type=int, default=1,
      help="table-parallel ways: shard the CSR hash table by bucket-key "
           "range over tp devices (for indexes larger than one card's "
           "memory); "
           "remaining devices map reads data-parallel")
    a("--seed-pattern", default="3", choices=("3", "5", "7"),
      help="spaced seed pattern (reference compile-time -D SEEDPATTERN*)")
    a("--resume", dest="resume", action="store_true",
      help="checkpoint after every batch and continue an interrupted run "
           "from its last completed batch (walt_tpu.host.resume)")
    a("--multihost", dest="multihost", action="store_true",
      help="multi-host pod-slice run (jax.distributed): read files are "
           "data-parallel round-robin across processes; outputs must be "
           "1:1 with inputs so every file's output is byte-identical to a "
           "single-host run (walt_tpu.parallel.multihost)")
    return p


def _about_or_help(argv, parser, prog: str, descr: str) -> bool:
    """OptionParser's ``-about`` / ``-?`` surface (OptionParser.cpp:382-386).

    ``-about`` prints the "PROGRAM: <name>" banner plus the program
    description (about_message, OptionParser.cpp:433-452); ``-?`` is a help
    alias (argparse already covers -h/--help).
    """
    if any(a in ("-about", "--about") for a in argv):
        print(f"PROGRAM: {prog}")
        print(descr)
        return True
    if "-?" in argv:
        parser.print_help()
        return True
    return False


def main_map(argv=None) -> int:
    argv = _apply_config_file(sys.argv[1:] if argv is None else argv)
    parser = build_map_parser()
    # description mirrors walt.cpp:130 so `-about` output matches shape
    if _about_or_help(argv, parser, "waltx", "map Illumina BS-seq reads"):
        return 0
    args = parser.parse_args(argv)
    _validate_index(args.index)

    se_files = _split_filenames(args.reads)
    pe1 = _split_filenames(args.reads1)
    pe2 = _split_filenames(args.reads2)
    if len(pe1) != len(pe2):
        raise SystemExit("unequal number of end1 and end2 files")
    for f in se_files + pe1 + pe2:
        if not f.endswith(FASTQ_SUFFIXES):
            raise SystemExit(f"read file invalid suffix: {f}")

    outputs = _split_filenames(args.output)
    n_runs = len(se_files) + len(pe1)
    if len(outputs) != 1 and len(outputs) != n_runs:
        raise SystemExit(f"wrong number of output files: {args.output}")
    if len(outputs) == 1:
        outputs = outputs * n_runs

    if args.batch > MAX_BATCH:
        raise SystemExit(f"batch size may not exceed {MAX_BATCH}")
    if not (2 <= args.top_k <= 300):
        raise SystemExit("paired-end candidates must be in [2, 300]")

    # multi-host: file-granular data parallelism across jax processes; each
    # run's outputs are byte-identical to a single-host run of that file
    pid, nproc = 0, 1
    if args.multihost:
        from walt_tpu.parallel import multihost

        # populate the heap BEFORE joining the coordination service: a
        # multi-GB MADV_POPULATE_WRITE through a userfaultfd-served VMM can
        # outlast the jax.distributed heartbeat timeout (~100 s) when every
        # host does it at once, and the stalled fault path takes the
        # heartbeat threads down with it
        from walt_tpu.hostmem import prefault as _prefault

        _prefault()
        pid, nproc = multihost.initialize()
        if len(set(outputs)) != n_runs:
            raise SystemExit(
                "--multihost needs one output file per input file"
            )

    # clear output files so later appends make sense (walt.cpp:229-233);
    # under --resume the drivers restore/truncate from their checkpoints.
    # Under --multihost each process touches only its own runs' outputs.
    shared_output = len(set(outputs)) != len(outputs)
    if not args.resume:
        for oi, out in enumerate(outputs):
            if oi % nproc != pid:
                continue
            open(out, "w").close()
            open(out + ".mapstats", "w").close()
    elif shared_output:
        # several runs append to one output: truncate only a genuinely
        # fresh output (no run checkpoint exists yet)
        import glob

        for out in set(outputs):
            if not glob.glob(glob.escape(out) + ".waltx_ckpt*"):
                open(out, "w").close()
                open(out + ".mapstats", "w").close()

    from walt_tpu.core.backends import get_backend
    from walt_tpu.hostmem import prefault

    prefault()  # batch-populate the heap before the large-array pipeline
    # the jax backend spans every visible device as a ('dp','tp') mesh --
    # the production multi-chip path (OpenMP fan-out analog, mapping.cpp:494)
    backend = (
        get_backend("jax", mesh="auto", tp=args.tp)
        if args.backend == "jax" else get_backend(args.backend)
    )
    if args.threads > 1:
        from walt_tpu.host import replay as _replay

        _replay.set_host_threads(args.threads)

    oi = 0
    from walt_tpu.core.single_end import process_single_end

    def _tag(i):
        return f".run{i}" if (args.resume and shared_output) else ""

    def _fresh(b):
        # per-file reset: file N's phase schedule must not depend on file N-1
        if hasattr(b, "reset_adaptive"):
            b.reset_adaptive()
        return b

    for f in se_files:
        if oi % nproc == pid:
            process_single_end(
                args.index, f, outputs[oi], batch_size=args.batch,
                max_mismatches=args.mismatch, b=args.bucket,
                adaptor=args.adaptor,
                ag_wildcard=args.ag_wildcard or args.pbat,
                ambiguous=args.ambiguous,
                unmapped=args.unmapped, sam=args.sam, backend=_fresh(backend),
                pattern_name=args.seed_pattern, verbose=args.verbose,
                resume=args.resume, ckpt_tag=_tag(oi),
            )
        oi += 1

    from walt_tpu.core.paired_end import process_paired_end

    for f1, f2 in zip(pe1, pe2):
        if oi % nproc == pid:
            process_paired_end(
                args.index, f1, f2, outputs[oi], batch_size=args.batch,
                max_mismatches=args.mismatch, b=args.bucket,
                adaptor=args.adaptor,
                top_k=args.top_k, frag_range=args.fraglen,
                ambiguous=args.ambiguous, unmapped=args.unmapped, sam=args.sam,
                backend=_fresh(backend), pattern_name=args.seed_pattern,
                verbose=args.verbose, pbat=args.pbat,
                resume=args.resume, ckpt_tag=_tag(oi),
            )
        oi += 1
    if args.multihost:
        multihost.barrier("waltx-map-done")
    return 0


def main_index(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="waltx index", description="build index for reference genome"
    )
    p.add_argument("-c", "-chrom", "--chrom", dest="chrom", required=True,
                   help="chromosomes in FASTA file or dir ('.fa')")
    p.add_argument("-o", "-output", "--output", dest="output", required=True,
                   help="output file name (suffix '.dbindex')")
    p.add_argument("--seed-pattern", default="3", choices=("3", "5", "7"))
    p.add_argument("--rand-seed", type=int, default=0,
                   help="seed for non-ACGT randomization (reference uses "
                        "time(NULL), which is irreproducible)")
    # description mirrors makedb.cpp:93 for `-about` parity
    if _about_or_help(argv or [], p, "waltx index",
                      "build index for reference genome"):
        return 0
    args = p.parse_args(argv)
    if not args.output.endswith(".dbindex"):
        raise SystemExit("The suffix of the output file should be '.dbindex'")

    from walt_tpu.constants import get_pattern
    from walt_tpu.genome import identify_chromosomes
    from walt_tpu.hostmem import prefault
    from walt_tpu.index.build import build_all_tables
    from walt_tpu.index.io_walt import write_index

    prefault()
    files = identify_chromosomes(args.chrom)
    genome, tables = build_all_tables(
        files, get_pattern(args.seed_pattern), seed=args.rand_seed
    )
    write_index(args.output, genome, tables)
    return 0


def main_merge_stats(argv) -> int:
    p = argparse.ArgumentParser(
        prog="waltx merge-stats",
        description="sum .mapstats files from split-input runs into one",
    )
    p.add_argument("stats", nargs="+", help="per-part .mapstats files")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)

    from walt_tpu.parallel.multihost import merge_mapstats

    merge_mapstats(args.stats, args.output)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "index":
        return main_index(argv[1:])
    if argv and argv[0] == "merge-stats":
        return main_merge_stats(argv[1:])
    if argv and argv[0] == "map":
        argv = argv[1:]
    return main_map(argv)


if __name__ == "__main__":
    raise SystemExit(main())
