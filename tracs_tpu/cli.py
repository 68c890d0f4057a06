"""CLI dispatcher: ``tracs-tpu <align|combine|distance|threshold|cluster|
build-db|pipe|plot>`` — subcommand parity with the reference
(tracs/__main__.py:15-57)."""

from __future__ import annotations

import argparse

from tracs_tpu import __version__
from tracs_tpu.stages.align import align_parser
from tracs_tpu.stages.build_db import build_db_parser
from tracs_tpu.stages.cluster import cluster_parser
from tracs_tpu.stages.combine import combine_parser
from tracs_tpu.stages.distance import distance_parser
from tracs_tpu.stages.doctor import doctor_parser
from tracs_tpu.stages.pipe import pipe_parser
from tracs_tpu.stages.plots import plots_parser
from tracs_tpu.stages.threshold import threshold_parser


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tracs-tpu")
    subparsers = parser.add_subparsers(help="select a subcommand", dest="command")

    parser.add_argument(
        "--version", action="version", version="%(prog)s " + __version__
    )

    align_parser(subparsers.add_parser("align"))
    combine_parser(subparsers.add_parser("combine"))
    distance_parser(subparsers.add_parser("distance"))
    threshold_parser(subparsers.add_parser("threshold"))
    cluster_parser(subparsers.add_parser("cluster"))
    build_db_parser(subparsers.add_parser("build-db"))
    pipe_parser(subparsers.add_parser("pipe"))
    plots_parser(subparsers.add_parser("plot"))
    doctor_parser(subparsers.add_parser("doctor"))

    args = parser.parse_args(argv)
    try:
        func = args.func
    except AttributeError:
        parser.error("Too few inputs. For help, run tracs-tpu --help")
    # refuse a run that landed on the CPU when JAX_PLATFORMS asked for an
    # accelerator (distance checks before its sweep; this catches the rest)
    import tracs_tpu

    try:
        rc = func(args)
        tracs_tpu.check_platform()
    except tracs_tpu.PlatformFallbackError as e:
        parser.exit(2, f"tracs-tpu: error: {e}\n")
    if isinstance(rc, int) and rc:  # doctor-style preflights signal via exit code
        raise SystemExit(rc)
    return


if __name__ == "__main__":
    main()
