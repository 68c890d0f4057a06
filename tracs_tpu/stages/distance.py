"""``distance`` stage: pairwise SNP + transmission distances per MSA.

CLI/CSV parity with reference tracs/distance.py (flags distance.py:15-131,
CSV schema distance.py:156-158: ``sampleA,sampleB,date difference,
SNP distance,transmission distance,expected K,filtered SNP distance,
sites considered,MSA file``), with the compute redesigned for an
accelerator: the C++ pairsnp call becomes int8 channel-gram GEMMs on the
device and the transcluster hash-memoised loop becomes a batched
vectorised while_loop
(see ops/pairsnp.py, models/transcluster.py).
"""

from __future__ import annotations

import argparse
import logging
import os
from datetime import date

import numpy as np

from tracs_tpu.models.transcluster import calculate_trans_prob
from tracs_tpu.ops.pairsnp import INT32_MAX, pairsnp
from tracs_tpu.runtime.native import native_format_rows
from tracs_tpu.utils import add_loglevel_arg, check_positive_float, check_positive_int, setup_logging


def distance_parser(parser):
    parser.description = (
        "Estimates pairwise SNP and transmission distances between each pair "
        "of samples aligned to the same reference genome."
    )

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "--msa", dest="msa_files", required=True,
        help="Input fasta files formatted by the align and merge functions",
        type=os.path.abspath, nargs="+",
    )
    io_opts.add_argument(
        "--msa-db", dest="msa_db",
        help="A database MSA used to compare each sequence to. By default "
             "all pairwise comparisons within each MSA are considered.",
        type=os.path.abspath, default=None,
    )
    io_opts.add_argument(
        "--meta", dest="metadata", default=None,
        help="Location of metadata in csv format. The first column must "
             "include the sequence names and the second column must include "
             "sampling dates.",
        type=os.path.abspath,
    )
    io_opts.add_argument(
        "-o", "--output", dest="output_file", required=True,
        help="name of the output file to store the pairwise distance estimates.",
        type=str,
    )

    snpdist = parser.add_argument_group("SNP distance options")
    snpdist.add_argument(
        "-D", "--snp_threshold", dest="snp_threshold",
        help="Only output those transmission pairs with a SNP distance <= D",
        type=check_positive_int, default=INT32_MAX,
    )
    snpdist.add_argument(
        "--filter", dest="recomb_filter",
        help="Filter out regions with unusually high SNP distances often caused by HGT",
        action="store_true", default=False,
    )

    transdist = parser.add_argument_group("Transmission distance options")
    transdist.add_argument(
        "--clock_rate", dest="clock_rate",
        help="clock rate as defined in the transcluster paper "
             "(SNPs/genome/year) default=1e-3 * 29903",
        type=check_positive_float, default=1e-3 * 29903,
    )
    transdist.add_argument(
        "--trans_rate", dest="trans_rate",
        help="transmission rate as defined in the transcluster paper "
             "(transmissions/year) default=73",
        type=check_positive_float, default=73.0,
    )
    transdist.add_argument(
        "-K", "--trans_threshold", dest="trans_threshold",
        help="Only outputs those pairs where the most likely number of "
             "intermediate hosts <= K",
        type=check_positive_int, default=None,
    )
    transdist.add_argument(
        "--precision", dest="precision",
        help="The precision used to calculate E(K) (default=0.01).",
        type=check_positive_float, default=0.01,
    )

    scale = parser.add_argument_group("Scale options")
    scale.add_argument(
        "--row-block", dest="row_block", type=check_positive_int, default=None,
        help="Stream the all-pairs computation in row blocks of this many "
             "samples (bounds host memory for very large runs and enables "
             "--resume). Default: whole matrix at once.",
    )
    scale.add_argument(
        "--resume", dest="resume", action="store_true", default=False,
        help="Resume an interrupted --row-block run from the cursor file "
             "written next to the output.",
    )
    scale.add_argument(
        "--mesh", dest="mesh", type=str, default=None,
        help="Device mesh for the all-pairs sweep: 'auto' (default: all "
             "visible devices, data-parallel over DB sample shards), "
             "'off' (single device), an explicit 'DPxSP' shape, e.g. "
             "'4x2' = 4 sample shards x 2 genome-position shards, or "
             "'global' (all devices of every process under an SPMD "
             "jax.distributed launch). Output is identical for every "
             "shape. Env: TRACS_TPU_MESH.",
    )

    parser.add_argument(
        "-t", "--threads", dest="n_cpu",
        help="number of threads to use (default=1)",
        type=check_positive_int, default=1,
    )
    add_loglevel_arg(parser)
    parser.set_defaults(func=distance)
    return parser


def distance(args):
    setup_logging(args.loglevel)

    logging.info("Loading metadata...")
    dates = None
    if args.metadata is not None:
        dates = {}
        with open(args.metadata, "r") as infile:
            next(infile)
            for line in infile:
                line = line.strip().split(",")
                dates[line[0]] = (line[1], date.fromisoformat(line[1]))

    # multi-chip: resolve the mesh once; any >1-device mesh routes through
    # the streaming driver (row blocks are how the sharded sweep is fed).
    # 'auto' shapes get the workload dims (sample count + packed word
    # count of the first MSA) so the dp/sp split is HBM/length-aware —
    # one O(bytes) peek next to the O(n^2 L) work it informs.
    import jax

    import tracs_tpu
    from tracs_tpu.parallel.mesh import resolve_mesh

    # initialise the backends now, so a CPU fallback is refused before the
    # sweep rather than after it
    jax.devices()
    tracs_tpu.check_platform()
    spec = getattr(args, "mesh", None)
    n_peek = w_peek = None
    if len(jax.devices()) > 1 and (
        (spec or os.environ.get("TRACS_TPU_MESH", "auto")).strip().lower()
        in ("auto", "global")
    ):
        n_peek, w_peek = _peek_fasta_dims(args.msa_files[0])
    args.resolved_mesh = resolve_mesh(spec, n_samples=n_peek, n_words=w_peek)
    if args.resolved_mesh is not None:
        logging.info(
            "Running on a %s device mesh",
            dict(args.resolved_mesh.shape),
        )
        if not getattr(args, "row_block", None):
            args.row_block = 1024

    # SPMD multi-process: every process runs the same program (required
    # for the collectives), but only one may own the output path — the
    # others write their (byte-identical) copy next to it, which doubles
    # as a cross-host determinism check
    import jax

    if jax.process_count() > 1 and jax.process_index() > 0:
        args.output_file = f"{args.output_file}.proc{jax.process_index()}"
        logging.info("process %d writes %s", jax.process_index(), args.output_file)

    if getattr(args, "row_block", None):
        return _distance_streaming(args, dates)

    # large inputs stream automatically: bounded host memory + resumable.
    # Every MSA counts — any single large file is reason enough to stream.
    n_first = 0
    for path in args.msa_files:
        try:
            n_first = max(
                n_first,
                sum(1 for line in _open_any(path) if line.startswith(">")),
            )
        except OSError:
            pass
    if n_first > 4096:
        logging.info(
            "%s samples detected: switching to streaming row blocks "
            "(use --row-block to control the block size)", n_first,
        )
        args.row_block = 1024
        return _distance_streaming(args, dates)

    logging.info("Estimating transmission distances...")

    with open(args.output_file, "w") as outfile:
        outfile.write(
            "sampleA,sampleB,date difference,SNP distance,transmission distance,"
            "expected K,filtered SNP distance,sites considered,MSA file\n"
        )
        for msa in args.msa_files:
            logging.info("Calculating pairwise snp distances for %s", msa)
            msas = [msa, args.msa_db] if args.msa_db is not None else [msa]

            snp_dists = list(
                pairsnp(
                    fasta=msas,
                    n_threads=args.n_cpu,
                    dist=args.snp_threshold,
                    filter=args.recomb_filter,
                )
            )
            names = snp_dists[3]

            if (args.metadata is not None) and (len(snp_dists[0]) > 0):
                logging.info("Inferring transmission probabilities for %s", msa)
                # with --filter, filtered distances replace raw ones in the
                # transmission model (reference distance.py:182-204)
                dist_col = snp_dists[4] if args.recomb_filter else snp_dists[2]
                transmission_dists, expectedk, datediff = calculate_trans_prob(
                    snp_dists[:2] + [dist_col],
                    sample_dates=dates,
                    K=100,
                    lamb=args.clock_rate,
                    beta=args.trans_rate,
                    samplenames=names,
                    log=False,
                    precision=args.precision,
                )
                if not args.recomb_filter:
                    snp_dists[4] = ["NA"] * len(snp_dists[2])

            logging.info("Saving distances for %s", msa)
            ref = os.path.basename(msa).split(".")[0]
            ref = ref.replace("_combined", "")

            if (args.metadata is not None) and (len(snp_dists[0]) > 0):
                eK_arr = np.asarray(expectedk)
                if args.trans_threshold is not None:
                    keep = np.nonzero(args.trans_threshold >= eK_arr)[0]
                else:
                    keep = np.arange(len(snp_dists[0]))
                txt = native_format_rows(
                    names,
                    np.asarray(snp_dists[0])[keep], np.asarray(snp_dists[1])[keep],
                    np.asarray(snp_dists[2])[keep], np.asarray(snp_dists[5])[keep],
                    ref, datediff=np.asarray(datediff)[keep],
                    p0=np.asarray(transmission_dists)[keep], eK=eK_arr[keep],
                    filt=(np.asarray(snp_dists[4])[keep] if args.recomb_filter else None),
                )
                if txt is not None:
                    outfile.write(txt)
                else:
                    for i, j, dateD, snpD, expK, tranD, filtD, ncomp in zip(
                        snp_dists[0], snp_dists[1], datediff, snp_dists[2],
                        expectedk, transmission_dists, snp_dists[4], snp_dists[5],
                    ):
                        if (args.trans_threshold is None) or (args.trans_threshold >= expK):
                            outfile.write(
                                ",".join(
                                    [
                                        names[i], names[j], str(dateD), str(int(snpD)),
                                        str(tranD), str(expK), str(filtD), str(ncomp), ref,
                                    ]
                                )
                                + "\n"
                            )
            elif len(snp_dists[0]) > 0:
                txt = native_format_rows(
                    names,
                    np.asarray(snp_dists[0]), np.asarray(snp_dists[1]),
                    np.asarray(snp_dists[2]), np.asarray(snp_dists[5]),
                    ref, filt=np.asarray(snp_dists[4]),
                )
                if txt is not None:
                    outfile.write(txt)
                else:
                    for i, j, snpD, filtD, ncomp in zip(
                        snp_dists[0], snp_dists[1], snp_dists[2], snp_dists[4], snp_dists[5]
                    ):
                        outfile.write(
                            ",".join(
                                [
                                    names[i], names[j], "NA", str(int(snpD)),
                                    "NA", "NA", str(filtD), str(ncomp), ref,
                                ]
                            )
                            + "\n"
                        )
    return


def _open_any(path):
    import gzip

    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _peek_fasta_dims(path):
    """(n_samples, n_words) of one MSA, for shaping the auto mesh.

    The first record is walked line-by-line for its length; the remaining
    headers are counted in bulk 16 MB binary chunks (no per-line Python
    for multi-GB files).  Returns (None, None) when unreadable — the mesh
    planner then falls back to its dimension-free default."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    try:
        with opener(path, "rb") as fh:
            n = 0
            length = 0
            for line in fh:
                if line.startswith(b">"):
                    n += 1
                    if n == 2:
                        break
                elif n == 1:
                    length += len(line.rstrip())
            prev_nl = True
            while True:
                chunk = fh.read(1 << 24)
                if not chunk:
                    break
                n += chunk.count(b"\n>")
                if prev_nl and chunk.startswith(b">"):
                    n += 1
                prev_nl = chunk.endswith(b"\n")
    except OSError:
        return None, None
    if n == 0 or length == 0:
        return None, None
    return n, (length + 31) // 32


def _distance_streaming(args, dates):
    """Row-block streaming driver for very large all-pairs runs: bounded
    host memory, incremental CSV writes, and a cursor file so interrupted
    sweeps resume at the last completed block (SURVEY.md §5 checkpoint
    story).  Output rows are identical to the non-streaming path."""
    import json

    from tracs_tpu.models.transcluster import SECONDS_IN_YEAR, TransClusterCache
    from tracs_tpu.ops.pairsnp import pairsnp_stream
    from tracs_tpu.runtime.profiling import phase, rate_logger
    from datetime import date as _date

    cursor_path = args.output_file + ".cursor"
    cursor = {"msa_index": 0, "next_row": 0}
    mode = "w"
    if getattr(args, "resume", False) and os.path.exists(cursor_path):
        with open(cursor_path) as fh:
            cursor = json.load(fh)
        mode = "a"
        logging.info("Resuming from %s", cursor)
        # SIGKILL-anywhere safety: the cursor snapshots the flushed byte
        # offset AFTER each block, so anything past it (a partial line from
        # a kill mid-write, or a complete block whose cursor update never
        # landed) is discarded and re-emitted — the resumed CSV is byte-
        # identical to an uninterrupted run
        if "bytes" in cursor and os.path.exists(args.output_file):
            with open(args.output_file, "r+") as fh:
                fh.truncate(cursor["bytes"])

    cache = TransClusterCache(args.clock_rate, args.trans_rate, args.precision)
    reftime = _date.fromisoformat("1970-01-01")

    def secs(name):
        return (dates[name][1] - reftime).total_seconds()

    # lazily-filled per-sample seconds, so datediff per block is one numpy
    # gather instead of O(pairs) dict work; a missing date still raises
    # KeyError on the sample's first emitted pair (reference parity)
    secs_arr = None
    secs_known = None

    def datediff_for(names, rows, cols):
        nonlocal secs_arr, secs_known
        if secs_arr is None or secs_arr.size < len(names):
            secs_arr = np.zeros(len(names))
            secs_known = np.zeros(len(names), dtype=bool)
        needed = np.unique(np.concatenate([rows, cols]))
        for i in needed[~secs_known[needed]]:
            secs_arr[i] = secs(names[i])
            secs_known[i] = True
        return np.abs(secs_arr[rows] - secs_arr[cols]) / SECONDS_IN_YEAR

    with open(args.output_file, mode) as outfile:
        if mode == "w":
            outfile.write(
                "sampleA,sampleB,date difference,SNP distance,transmission "
                "distance,expected K,filtered SNP distance,sites considered,MSA file\n"
            )
        for mi, msa in enumerate(args.msa_files):
            if mi < cursor["msa_index"]:
                continue
            start_row = cursor["next_row"] if mi == cursor["msa_index"] else 0
            ref = os.path.basename(msa).split(".")[0].replace("_combined", "")
            msas = [msa, args.msa_db] if args.msa_db is not None else [msa]
            logging.info("Streaming pairwise distances for %s", msa)
            log_rate = rate_logger("pairs")
            blob_cache = {}  # per-MSA: the names blob is shared across blocks
            secs_arr = secs_known = None  # per-MSA sample indexing
            def format_block(names, rows, cols, dvals, filt, nn):
                """CSV text for one block (transcluster + formatting) —
                the host-CPU half of a block, run on the pipeline worker
                while the device computes the next block."""
                if dates is not None and len(rows):
                    dist_col = filt if args.recomb_filter else dvals
                    datediff = datediff_for(names, rows, cols)
                    p0, eK = cache.lookup(dist_col, datediff)
                    p0 = np.exp(p0)
                    if args.trans_threshold is not None:
                        keep = np.nonzero(args.trans_threshold >= eK)[0]
                    else:
                        keep = np.arange(len(rows))
                    txt = native_format_rows(
                        names, rows[keep], cols[keep], dvals[keep],
                        nn[keep], ref, datediff=datediff[keep],
                        p0=p0[keep], eK=eK[keep],
                        filt=(filt[keep] if args.recomb_filter else None),
                        _blob_cache=blob_cache,
                    )
                    if txt is None:
                        lines = [
                            f"{names[rows[k]]},{names[cols[k]]},{datediff[k]},"
                            f"{int(dvals[k])},{p0[k]},{eK[k]},"
                            f"{filt[k] if args.recomb_filter else 'NA'},{nn[k]},{ref}"
                            for k in keep
                        ]
                        txt = "\n".join(lines) + "\n" if lines else ""
                elif len(rows):
                    txt = native_format_rows(
                        names, rows, cols, dvals, nn, ref, filt=filt,
                        _blob_cache=blob_cache,
                    )
                    if txt is None:
                        lines = [
                            f"{names[rows[k]]},{names[cols[k]]},NA,"
                            f"{int(dvals[k])},NA,NA,{filt[k]},{nn[k]},{ref}"
                            for k in range(len(rows))
                        ]
                        txt = "\n".join(lines) + "\n"
                else:
                    txt = ""
                return txt

            def write_block(r0, r1, n_names, fut):
                """Join the worker, write its CSV text, advance the cursor
                — blocks land strictly in row order, so the resume
                contract (cursor = flushed byte offset of the last
                complete block) is untouched by the pipelining."""
                fut[1].join()
                if isinstance(fut[0], BaseException):
                    raise fut[0]  # e.g. KeyError for a missing sample date
                with phase("block rows [%d,%d)" % (r0, r1)):
                    if fut[0]:
                        outfile.write(fut[0])
                    outfile.flush()
                    # atomic cursor update (a kill mid-json would otherwise
                    # leave an unreadable cursor)
                    state = {"msa_index": mi, "next_row": r1,
                             "bytes": outfile.tell()}
                    with open(cursor_path + ".tmp", "w") as fh:
                        json.dump(state, fh)
                    os.replace(cursor_path + ".tmp", cursor_path)
                log_rate((r1 - r0) * (n_names - r0))

            # one-deep host pipeline: block k's transcluster + formatting
            # run on a worker thread while the generator's next() waits on
            # block k+1's device sweep/download.  Exactly one worker is
            # alive at a time (started only after the previous one was
            # joined), so the transcluster cache and the name-blob cache
            # see strictly serial access.
            import threading

            pipelined = os.environ.get("TRACS_TPU_PIPELINE_BLOCKS", "1") != "0"
            pending = None  # (r0, r1, len(names), [result, thread])
            for r0, r1, names, rows, cols, dvals, filt, nn in pairsnp_stream(
                msas, dist=args.snp_threshold, filter=args.recomb_filter,
                row_block=args.row_block, start_row=start_row,
                mesh=getattr(args, "resolved_mesh", None),
            ):
                if pending is not None:
                    write_block(*pending)
                    pending = None
                fut = [None, None]

                def work(fut=fut, a=(names, rows, cols, dvals, filt, nn)):
                    try:
                        fut[0] = format_block(*a)
                    except BaseException as e:  # noqa: BLE001 — re-raised on join
                        fut[0] = e

                if pipelined:
                    th = threading.Thread(target=work, daemon=True)
                    fut[1] = th
                    th.start()
                else:
                    work()
                    fut[1] = threading.Thread(target=lambda: None)
                    fut[1].start()
                pending = (r0, r1, len(names), fut)
            if pending is not None:
                write_block(*pending)
            cursor = {"msa_index": mi + 1, "next_row": 0}
    if os.path.exists(cursor_path):
        os.remove(cursor_path)
    logging.info("Streaming distance run complete.")
    return


def main():
    parser = argparse.ArgumentParser()
    parser = distance_parser(parser)
    args = parser.parse_args()
    args.func(args)
    return


if __name__ == "__main__":
    main()
