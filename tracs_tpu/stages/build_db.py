"""``build-db`` stage: reference database zip construction.

Database layout kept from reference tracs/build_db.py so databases are
interchangeable: ``<dbname>.zip`` holding each genome as
``<prefix>.fasta.gz``, a ``summary.tsv`` manifest, and — when sourmash is
installed — a ``sourmashDB.sbt.zip`` SBT index for ``sourmash gather``.
Inputs are either many fasta paths or a single ``path,prefix`` CSV list
file (reference build_db.py:123-132).

Differences from the reference: every database also embeds native FracMinHash
sketches (tracs_tpu/sketch.py), so ``align`` works with no sourmash binary
at all; genomes are streamed straight into the archive (no temp-dir
copies); and ``summary.tsv`` rows are newline-separated (the reference
concatenates them onto one line, build_db.py:158-160 — nothing parses the
file, so the fixed format is kept).
"""

from __future__ import annotations

import argparse
import gzip
import logging
import shutil
import subprocess
import tempfile
from pathlib import Path
from zipfile import ZIP_STORED, ZipFile

from tracs_tpu.io.external import require_tool, run_sketch
from tracs_tpu.utils import add_loglevel_arg, setup_logging


def build_db_parser(parser):
    parser.description = "Builds a reference database"

    parser.add_argument(
        "-i", "--input", dest="input_files", required=True,
        help="path to genome fasta files (one per reference genome).",
        type=Path, nargs="+",
    )
    parser.add_argument(
        "-o", "--output", dest="dbname", required=True,
        help="name of the database file", type=Path,
    )
    parser.add_argument(
        "--ksize", dest="ksize", default=51, type=int,
        help="the kmer length used in sourmash (default=51)",
    )
    parser.add_argument(
        "--scale", dest="scale", default=1000, type=int,
        help="the scale used in sourmash (default=1000)",
    )
    parser.add_argument(
        "-t", "--threads", dest="n_cpu", default=1, type=int,
        help="number of threads to use (default=1)",
    )
    add_loglevel_arg(parser)
    parser.set_defaults(func=build_db)
    return parser


def _genome_manifest(input_files: list[Path]) -> list[tuple[Path, str]]:
    """[(fasta_path, prefix)] from the CLI inputs.  A single non-fasta
    argument is a ``prefix,path`` CSV list file (reference column order,
    build_db.py:125-128); otherwise prefixes come from file stems."""
    if len(input_files) == 1 and not _looks_like_fasta(input_files[0]):
        rows = []
        for line in input_files[0].read_text().splitlines():
            if not line.strip():
                continue
            prefix, path = line.strip().split(",")[:2]
            rows.append((Path(path), prefix))
        return rows
    return [(f, f.name.rsplit(".", 1)[0]) for f in input_files]


def _looks_like_fasta(path: Path) -> bool:
    suffix = path.name.lower()
    return any(
        suffix.endswith(ext)
        for ext in (".fa", ".fasta", ".fna", ".fa.gz", ".fasta.gz", ".fna.gz")
    )


def _archive_genome(archive: ZipFile, fasta: Path, prefix: str) -> None:
    """Store the genome in the archive as <prefix>.fasta.gz — already-gzipped
    inputs are stored as-is, plain fasta is gzip-streamed straight into the
    zip member (no temp file)."""
    member = f"{prefix}.fasta.gz"
    if fasta.name.endswith(".gz"):
        archive.write(fasta, member)
        return
    with archive.open(member, "w") as raw, open(fasta, "rb") as src:
        with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as gz:
            shutil.copyfileobj(src, gz)


def _sourmash_index(genomes: list[tuple[Path, str]], workdir: Path, *,
                    ksize: int, scale: int, n_cpu: int) -> Path:
    """Sketch every genome and index the signatures into an SBT zip
    (command contracts: ``sourmash sketch dna`` via io.external.run_sketch,
    then ``sourmash index``)."""
    require_tool("sourmash")
    from joblib import Parallel, delayed

    sig_dir = Path(tempfile.mkdtemp(dir=workdir))
    Parallel(n_jobs=n_cpu)(
        delayed(run_sketch)(
            [str(fasta)], prefix, str(sig_dir / f"{prefix}.sig"), ksize, scale
        )
        for fasta, prefix in genomes
    )
    sbt = workdir / "sourmashDB.sbt.zip"
    sigs = sorted(str(p) for p in sig_dir.glob("*.sig"))
    logging.info("indexing %d signatures into %s", len(sigs), sbt)
    subprocess.run(["sourmash", "index", str(sbt), *sigs], check=True)
    shutil.rmtree(sig_dir)
    return sbt


def build_db(args):
    setup_logging(args.loglevel)

    genomes = _genome_manifest(list(args.input_files))
    if not genomes:
        raise SystemExit("no input genomes given")
    db_path = Path(f"{args.dbname}.zip")
    db_path.parent.mkdir(parents=True, exist_ok=True)

    have_sourmash = shutil.which("sourmash") is not None
    with tempfile.TemporaryDirectory(dir=db_path.parent) as td:
        with ZipFile(db_path, "w", ZIP_STORED) as archive:
            if have_sourmash:
                sbt = _sourmash_index(
                    genomes, Path(td),
                    ksize=args.ksize, scale=args.scale, n_cpu=args.n_cpu,
                )
                archive.write(sbt, "sourmashDB.sbt.zip")
            else:
                logging.warning(
                    "sourmash not found: building the database with native "
                    "FracMinHash sketches only (align will use the native "
                    "gather)"
                )
            for fasta, prefix in genomes:
                logging.info("adding %s as %s.fasta.gz", fasta, prefix)
                _archive_genome(archive, fasta, prefix)
            manifest = "".join(
                f"{prefix},{prefix}.fasta.gz\n" for _f, prefix in genomes
            )
            archive.writestr("summary.tsv", manifest)

    # native FracMinHash sketches: every database is usable without sourmash
    from tracs_tpu.sketch import write_db_sketches

    write_db_sketches(
        str(db_path), [(str(f), p) for f, p in genomes],
        ksize=args.ksize, scaled=args.scale,
    )
    logging.info("database written to %s (%d genomes)", db_path, len(genomes))
    return


def main():
    parser = argparse.ArgumentParser()
    parser = build_db_parser(parser)
    args = parser.parse_args()
    args.func(args)
    return


if __name__ == "__main__":
    main()
