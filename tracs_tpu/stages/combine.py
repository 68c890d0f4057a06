"""``combine`` stage: gather per-sample align outputs into per-reference
combined alignments + merged metadata.

Output contracts kept from reference tracs/combine.py (same file names and
CSV schema so downstream tooling is interchangeable): per reference a
``<REF>_combined.fasta.gz`` with records renamed to their sample (exactly
one sequence per input file), and a ``combined_metadata.csv`` with columns
``sample,accession,intersect_bp,f_orig_query,f_match,f_unique_to_query,
coverage,mean_depth,mean_nonzero_depth,frac_N,species``.  The reference
leaves the three coverage columns "NA" (its pileup-depth helper is defined
but dead code, combine.py:84-103); here they stay "NA" by default for
output parity, and ``--coverage`` fills them from the per-sample pileups
via the native vectorised parser (io/pileup.py) instead of the reference's
line-by-line Python scan.
"""

from __future__ import annotations

import argparse
import csv
import gzip
import logging
import sys
from collections import defaultdict
from pathlib import Path

from tracs_tpu.io.fasta import read_fasta
from tracs_tpu.utils import add_loglevel_arg, setup_logging

_ALIGN_GLOB = "*posterior_counts_ref_*.fasta*"
_META_HEADER = (
    "sample,accession,intersect_bp,f_orig_query,f_match,f_unique_to_query,"
    "coverage,mean_depth,mean_nonzero_depth,frac_N,species"
)


def combine_parser(parser):
    parser.description = "Combine runs of align ready for distance estimation"

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "-i", "--input", dest="directories", required=True,
        help="Paths to each directory containing the output of the align function",
        type=Path, nargs="+",
    )
    io_opts.add_argument(
        "-o", "--output", dest="output_dir", required=True,
        help="name of the output directory to store the combined alignments.",
        type=Path,
    )

    parser.add_argument(
        "--coverage", dest="with_coverage", action="store_true", default=False,
        help="fill the coverage/mean_depth columns of combined_metadata.csv "
             "from the per-sample pileups (the reference schema leaves them "
             "NA; this uses the native pileup parser so it is cheap)",
    )
    parser.add_argument(
        "-t", "--threads", dest="n_cpu",
        help="number of threads to use (default=1)", type=int, default=1,
    )
    add_loglevel_arg(parser)
    parser.set_defaults(func=combine)
    return parser


def _sample_dirs(directories: list[Path]) -> list[Path]:
    """Expand the input spec: one non-directory argument is a file listing
    sample directories, one per line."""
    if len(directories) == 1 and not directories[0].is_dir():
        listing = directories[0].read_text().splitlines()
        directories = [Path(line.strip()) for line in listing if line.strip()]
    for d in directories:
        if not d.is_dir():
            logging.error("ERROR: %s is not a directory", d)
            sys.exit(1)
    return directories


def ref_of_alignment(path: Path) -> str:
    """Reference name encoded in an align-stage output file name."""
    stem = path.name
    marker = "posterior_counts_ref_"
    start = stem.find(marker)
    end = stem.rfind(".fasta")
    if start < 0 or end <= start:
        logging.error("ERROR: %s is not the expected output of align", path)
        sys.exit(1)
    return stem[start + len(marker):end]


def merge_ref_alignment(ref: str, entries: list[tuple[str, Path]], out_dir: Path):
    """Concatenate one reference's per-sample FASTAs into
    ``<REF>_combined.fasta.gz``, renaming each record to its sample.
    Returns {(sample, ref): (frac_N, length)}."""
    out_path = out_dir / f"{ref}_combined.fasta.gz"
    logging.info("Writing combined alignment for %s to %s", ref, out_path)
    frac_n = {}
    with gzip.open(out_path, "wt") as out:
        for sample, path in entries:
            records = read_fasta(path)
            name_seq = next(records, None)
            if name_seq is None:
                logging.error("ERROR: %s contains no sequence", path)
                sys.exit(1)
            if next(records, None) is not None:
                logging.error("ERROR: %s contains more than one sequence", path)
                sys.exit(1)
            seq = name_seq[1]
            out.write(f">{sample}\n{seq}\n")
            frac_n[(sample, ref)] = (seq.count("N") / len(seq), len(seq))
    return frac_n


def pileup_coverage(pileup: Path):
    """(covered_sites, mean_depth, mean_nonzero_depth) from one pileup via
    the vectorised parser — the working replacement for the reference's
    dead calculate_coverage (combine.py:84-103).  Depth counts A/C/G/T
    allele reads on either strand."""
    import numpy as np

    from tracs_tpu.io.pileup import scan_pileup_depth

    depth = scan_pileup_depth(pileup)
    if depth is None or depth.size == 0:
        return None
    covered = int(np.count_nonzero(depth))
    if covered == 0:
        return None
    return covered, float(depth.mean()), float(depth.sum() / covered)


def _coverage_by_key(directories: list[Path], n_cpu: int) -> dict:
    jobs = []
    for directory in directories:
        sample = directory.resolve().name
        for pileup in sorted(directory.glob("*ref_*_pileup.txt.gz")):
            name = pileup.name
            ref = name[name.find("ref_") + 4: name.rfind("_pileup")]
            jobs.append((sample, ref, pileup))
    from joblib import Parallel, delayed

    stats = Parallel(n_jobs=n_cpu)(
        delayed(pileup_coverage)(path) for _s, _r, path in jobs
    )
    return {
        (s, r): st for (s, r, _p), st in zip(jobs, stats) if st is not None
    }


def _merged_metadata_rows(directories, frac_n, coverage):
    """Rows of combined_metadata.csv from each sample's sourmash-hit CSVs.
    The accession is the first token of the gather 'name' column; the rest
    of that column is the species text."""
    for directory in directories:
        sample = directory.resolve().name
        for hits in sorted(directory.glob("*_sourmash_hits.csv")):
            with open(hits, newline="") as fh:
                reader = csv.reader(fh)
                next(reader, None)
                for row in reader:
                    if len(row) < 10:
                        continue
                    name_field = row[9].strip('"')
                    accession = name_field.split()[0]
                    species = name_field.replace(accession, "").strip()
                    cov = coverage.get((sample, accession))
                    cov_cols = (
                        [str(c) for c in cov] if cov else ["NA", "NA", "NA"]
                    )
                    nfrac = frac_n.get((sample, accession))
                    yield [
                        sample, accession, *row[:4], *cov_cols,
                        str(nfrac[0]) if nfrac else "NA", species,
                    ]


def combine(args):
    setup_logging(args.loglevel)

    directories = _sample_dirs(list(args.directories))
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    by_ref = defaultdict(list)
    for directory in directories:
        sample = directory.resolve().name
        for aln in sorted(directory.glob(_ALIGN_GLOB)):
            by_ref[ref_of_alignment(aln)].append((sample, aln))

    from joblib import Parallel, delayed

    frac_n = {}
    for part in Parallel(n_jobs=args.n_cpu)(
        delayed(merge_ref_alignment)(ref, entries, out_dir)
        for ref, entries in by_ref.items()
    ):
        frac_n.update(part)

    coverage = (
        _coverage_by_key(directories, args.n_cpu)
        if getattr(args, "with_coverage", False)
        else {}
    )

    meta_path = out_dir / "combined_metadata.csv"
    with open(meta_path, "w") as out:
        out.write(_META_HEADER + "\n")
        for row in _merged_metadata_rows(directories, frac_n, coverage):
            out.write(",".join(row) + "\n")
    return


def main():
    parser = argparse.ArgumentParser()
    parser = combine_parser(parser)
    args = parser.parse_args()
    args.func(args)
    return


if __name__ == "__main__":
    main()
