"""North-star scale run (BASELINE.json): 10k samples x 1 Mb all-pairs on
one device, composed as the REAL distance stage — ingest, streamed sweep,
transcluster, native CSV writer.

Phases (run sequentially; each its own process so host memory is freed
between them):

  python scripts/northstar.py prep <dir> [n] [L]      # fasta + dates
  python scripts/northstar.py cli <dir>               # timed real CLI run
  python scripts/northstar.py breakdown <dir>         # component shares

`cli` runs the actual `tracs-tpu distance` entry point end-to-end and
reports stage pairs/s (n^2 / wall).  `breakdown` reruns the same loop
with per-component timers: ingest/pack, device sweep + COO download,
transcluster lookups, CSV formatting+write; plus peak device memory if the
backend exposes memory_stats.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SNP_D = 200
ROW_BLOCK = 1024


def prep(outdir, n=10_000, L=1_000_000):
    from bench import make_clustered, write_dates, write_fasta

    os.makedirs(outdir, exist_ok=True)
    t0 = time.time()
    cluster_size = max(6, round(0.005 * n) + 1)
    packed = make_clustered(n, L, cluster_size=cluster_size)
    packed.names = [f"s{i}" for i in range(n)]
    print(f"# data gen: {time.time()-t0}s", file=sys.stderr)
    t0 = time.time()
    write_fasta(packed, os.path.join(outdir, "big.fasta"))
    print(f"# fasta write: {time.time()-t0}s", file=sys.stderr)
    write_dates(packed.names, os.path.join(outdir, "dates.csv"))
    print("# prep done", file=sys.stderr)


def cli(outdir, filt=0):
    import argparse

    from tracs_tpu.stages.distance import distance_parser

    # n from dates.csv (fast; prep writes one row per FASTA record).  The
    # assumption is cross-checked post-run against the CSV's sample span.
    n = sum(1 for _ in open(os.path.join(outdir, "dates.csv"))) - 1
    tag = "_filter" if filt else ""
    parser = distance_parser(argparse.ArgumentParser())
    args = parser.parse_args([
        "--msa", os.path.join(outdir, "big.fasta"),
        "--meta", os.path.join(outdir, "dates.csv"),
        "-o", os.path.join(outdir, f"dists{tag}.csv"),
        "-D", str(SNP_D), "--row-block", str(ROW_BLOCK), "--mesh", "off",
    ] + (["--filter"] if filt else []))
    t0 = time.time()
    args.func(args)
    wall = time.time() - t0
    rows = sum(1 for _ in open(os.path.join(outdir, f"dists{tag}.csv"))) - 1
    out = {
        "phase": "cli" + tag, "n": n, "wall_s": round(wall, 1),
        "stage_pairs_per_s": round(n * n / wall, 0), "rows": rows,
    }
    print(json.dumps(out))


def breakdown(outdir):
    from tracs_tpu.models.transcluster import SECONDS_IN_YEAR, TransClusterCache
    from tracs_tpu.ops.packing import pack_fasta
    from tracs_tpu.ops.pairsnp import (
        _cached_compact,
        _split_device,
        _split_pair,
        pairsnp_stream,
    )
    from tracs_tpu.runtime.native import native_format_rows

    t = {"pack": 0.0, "compact": 0.0, "split": 0.0, "upload": 0.0,
         "sweep": 0.0, "transcluster": 0.0, "write": 0.0}

    t0 = time.time()
    packed = pack_fasta(os.path.join(outdir, "big.fasta"))
    t["pack"] = time.time() - t0
    n = packed.n_seqs

    # sub-phases the streaming loop normally hides inside its first block:
    # variant-column compaction, the split-layout host build, and the
    # one-time device upload + on-device excl/nmask derivation (synced on
    # an 8-byte reduction)
    t0 = time.time()
    comp = _cached_compact(packed, packed)
    kern = comp[0] if comp is not None else packed
    t["compact"] = time.time() - t0
    t0 = time.time()
    sa, _ = _split_pair(kern, None)
    t["split"] = time.time() - t0
    t0 = time.time()
    import jax.numpy as jnp

    _Wpad, ea, _nm, _pt = _split_device(sa)
    float(jnp.sum(ea.ravel()[:2].astype(jnp.int64)))
    t["upload"] = time.time() - t0

    from datetime import date as _date

    reftime = _date.fromisoformat("1970-01-01")
    secs = np.zeros(n)
    with open(os.path.join(outdir, "dates.csv")) as fh:
        next(fh)
        for line in fh:
            name, ds = line.strip().split(",")
            secs[int(name[1:])] = (_date.fromisoformat(ds) - reftime).total_seconds()

    cache = TransClusterCache(1e-3 * 29903, 73.0, 0.01)  # the CLI default
    blob_cache = {}
    total_rows = 0
    ref = "big"
    t_all0 = time.time()
    with open(os.path.join(outdir, "dists_breakdown.csv"), "w") as outfile:
        outfile.write("sampleA,sampleB,date difference,SNP distance,"
                      "transmission distance,expected K,filtered SNP distance,"
                      "sites considered,MSA file\n")
        t0 = time.time()
        for r0, r1, names, rows, cols, dvals, filt, nn in pairsnp_stream(
                [packed], dist=SNP_D, row_block=ROW_BLOCK):
            t["sweep"] += time.time() - t0
            if len(rows):
                t0 = time.time()
                datediff = np.abs(secs[rows] - secs[cols]) / SECONDS_IN_YEAR
                p0, eK = cache.lookup(dvals, datediff)
                p0 = np.exp(p0)
                t["transcluster"] += time.time() - t0
                t0 = time.time()
                txt = native_format_rows(
                    names, rows, cols, dvals, nn, ref, datediff=datediff,
                    p0=p0, eK=eK, _blob_cache=blob_cache)
                outfile.write(txt)
                t["write"] += time.time() - t0
                total_rows += len(rows)
            t0 = time.time()
    wall = time.time() - t_all0

    hbm = None
    try:
        import jax

        stats = jax.local_devices()[0].memory_stats()
        hbm = int(stats.get("peak_bytes_in_use", 0))
    except Exception:
        pass

    out = {
        "phase": "breakdown", "n": n, "rows": total_rows,
        "pack_s": round(t["pack"], 1),
        "compact_s": round(t["compact"], 1),
        "split_s": round(t["split"], 1),
        "upload_s": round(t["upload"], 1),
        "loop_wall_s": round(wall, 1),
        "sweep_s": round(t["sweep"], 1),
        "transcluster_s": round(t["transcluster"], 1),
        "write_s": round(t["write"], 1),
        "loop_pairs_per_s": round(n * n / wall, 0),
        "peak_hbm_gb": round(hbm / 1e9, 2) if hbm else None,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    {"prep": prep, "cli": cli, "breakdown": breakdown}[sys.argv[1]](
        sys.argv[2], *map(int, sys.argv[3:])
    )
