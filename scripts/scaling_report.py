"""Scaling report: all-pairs throughput across mesh shapes.

Measures pairs/s for the ring all-pairs kernel on every dp x sp factorisation
of the available devices, plus the single-device dense kernel, and reports
scaling efficiency (BASELINE.md north star: >90% linear scaling).

On a single device this degenerates to the dense-kernel numbers; on a
multi-host deployment run one process per host with TRACS_TPU_COORDINATOR
set (see parallel/multihost.py).  To rehearse on virtual CPU devices:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/scaling_report.py --n 512 --L 100000

  python scripts/scaling_report.py --n 512 --L 1000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from tracs_tpu.ops.pairsnp import _cached_split, snp_distance_dense_split  # noqa: E402
from tracs_tpu.parallel.allpairs import sharded_snp_distance  # noqa: E402
from tracs_tpu.parallel.mesh import make_mesh  # noqa: E402
from tracs_tpu.parallel.multihost import initialize  # noqa: E402

from bench import make_clustered as make_packed  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--L", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    initialize()
    devices = jax.devices()
    print(f"# {len(devices)} devices: {devices[0].device_kind}", file=sys.stderr)

    packed = make_packed(args.n, args.L)
    sa = _cached_split(packed)

    results = {}

    # single device dense
    snp_distance_dense_split(sa, with_nn=False)
    t0 = time.time()
    for _ in range(args.iters):
        snp_distance_dense_split(sa, with_nn=False)
    rate1 = args.n * args.n / ((time.time() - t0) / args.iters)
    results["1x1"] = rate1
    print(f"# dense 1 device: {rate1:,.0f} pairs/s", file=sys.stderr)

    nd = len(devices)
    on_cpu = devices[0].platform == "cpu"
    shapes = sorted({(nd // s, s) for s in range(1, nd + 1) if nd % s == 0})
    for dp, sp in shapes:
        mesh = make_mesh(dp, sp)
        sharded_snp_distance(packed, mesh)  # compile + upload
        t0 = time.time()
        for _ in range(args.iters):
            sharded_snp_distance(packed, mesh)
        rate = args.n * args.n / ((time.time() - t0) / args.iters)
        results[f"{dp}x{sp}"] = rate
        if on_cpu:
            # virtual CPU devices share the host cores, so linear speedup is
            # physically impossible — the meaningful number is WORK
            # efficiency (sharded wall-clock vs single-device for the same
            # total job): 100% means the mesh schedule adds no overhead.
            eff = rate / rate1
            label = "work efficiency (shared-core CPU mesh)"
        else:
            eff = rate / (rate1 * nd)
            label = "of linear"
        print(
            f"# ring dp={dp} sp={sp}: {rate:,.0f} pairs/s "
            f"({100*eff:.0f}% {label})", file=sys.stderr,
        )

    print(json.dumps({"n": args.n, "L": args.L, "cpu_mesh": on_cpu,
                      "pairs_per_s": results}))


if __name__ == "__main__":
    main()
