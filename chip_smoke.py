#!/usr/bin/env python3
"""Smoke test of ``tracs-tpu distance`` on NVIDIA GPUs, at a real size.

    python chip_smoke.py              # one card: phases 0-4
    python chip_smoke.py --cards 4    # four cards: --mesh 4x1 and 2x2 vs off

One card, one process.  Phases:

0. device guard: JAX's first device must be a GPU; there is no fallback.
1. compile the production grams (``_dense_split_ranged``,
   ``_accum_split_ranged``) at the widths the stream uses for n=4096,
   L=1 Mb, rb=1024; print ``memory_analysis()``; require every matrix
   product to be a cuBLAS GEMM or a Triton GEMM fusion with s8 operands;
   profile one block and print the device time of the bit-unpack beside
   that of the int8 GEMMs.
2. the main path: a clustered 4096 x 1 Mb MSA from ``--seed`` (clusters of
   21) through ``tracs-tpu distance -D 200`` with dates.  The CSV must hold
   exactly the 40,950 within-cluster pairs; D and the comparable-site
   counts of 8 seed-chosen rows x all columns must equal the numpy oracle
   as integers, from both the int8-GEMM path and the popcount path.
3. the same CLI with ``--filter`` at 1024 x 1 Mb: the filtered distance of
   256 seed-chosen emitted pairs must equal the host oracle of
   tests/test_recomb.py.
4. the card-only checks of tests/gpu_checks.py.

``--cards 4`` runs phase 0 and then only the mesh path on phase 2's data.
Generated data lives in ``_smoke/`` (git-ignored) and is deleted at the
end.  Phase times are set-up times of this run, not metrics.  The last
line of a passing run is ``{"ok": true, "device": {...}}``; any failure
exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import importlib.util
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CLUSTER_SIZE = 21
SNP_THRESHOLD = 200


def require_gpu():
    """JAX's devices, when the first is a GPU; otherwise exit non-zero."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}"
        )
    return devices


def expected_pairs(n: int, cluster_size: int = CLUSTER_SIZE) -> set:
    """The (i, j), i < j, pairs of make_clustered's clusters: consecutive
    blocks of ``cluster_size`` samples."""
    return {
        (i, j)
        for i in range(n)
        for j in range(i + 1, min(n, (i // cluster_size + 1) * cluster_size))
    }


def read_csv(path: str) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def make_msa(work: str, n: int, L: int, seed: int, tag: str):
    """(packed, fasta path, dates path) of a clustered MSA from ``seed``."""
    import bench

    packed = bench.make_clustered(n, L, cluster_size=CLUSTER_SIZE, seed=seed)
    fasta = os.path.join(work, f"{tag}.fasta")
    dates = os.path.join(work, f"{tag}_dates.csv")
    bench.write_fasta(packed, fasta)
    bench.write_dates(packed.names, dates, seed=seed)
    return packed, fasta, dates


def run_distance(fasta: str, dates: str, out: str, *extra: str) -> None:
    from tracs_tpu.cli import main as cli_main

    cli_main(["distance", "--msa", fasta, "--meta", dates, "-o", out,
              "-D", str(SNP_THRESHOLD), *extra])


def check_pairs(rows: list[dict], n: int) -> None:
    got = {(int(r["sampleA"]), int(r["sampleB"])) for r in rows}
    want = expected_pairs(n)
    assert len(rows) == len(want), f"{len(rows)} CSV rows, expected {len(want)}"
    assert got == want, f"{len(got ^ want)} pairs differ from the clusters"


def phase_compile(n: int, L: int, rb: int) -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from tracs_tpu.ops.pairsnp import (
        _accum_split_ranged, _dense_split_ranged, overlap_chunk_words, plan_chunks,
    )

    W = (L + 31) // 32
    Wpad = -(-W // 256) * 256
    # the stream's first block: rows [0, rb) against every column
    c0 = 0
    cols = n - c0
    ea = jax.ShapeDtypeStruct((n, 4, Wpad), jnp.uint32)
    nm = jax.ShapeDtypeStruct((n, Wpad), jnp.uint32)
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    acc = jax.ShapeDtypeStruct((rb, cols), jnp.int32)
    wc, n_chunks = plan_chunks(rb + cols, 5, Wpad)
    chunk_w = overlap_chunk_words(Wpad)
    wc_o, n_chunks_o = plan_chunks(rb + cols, 5, chunk_w)
    compiled = {
        f"_dense_split_ranged(rb={rb}, c0={c0}, wc={wc}, n_chunks={n_chunks})":
            _dense_split_ranged.lower(
                ea, nm, i32, rb=rb, c0=c0, wc=wc, n_chunks=n_chunks
            ).compile(),
        f"_accum_split_ranged(rb={rb}, c0={c0}, chunk_w={chunk_w}, wc={wc_o}, "
        f"n_chunks={n_chunks_o})":
            _accum_split_ranged.lower(
                ea, nm, acc, acc, i32, i32, rb=rb, c0=c0, chunk_w=chunk_w,
                wc=wc_o, n_chunks=n_chunks_o,
            ).compile(),
    }
    for name, exe in compiled.items():
        print(f"# {name}")
        print(f"#   memory_analysis: {exe.memory_analysis()}")
        dots = bench.dot_lowerings(exe.as_text())
        for d in dots:
            print(f"#   dot -> {d['impl']}: {d['lhs']} x {d['rhs']} -> {d['out']}")
        assert dots, f"{name}: no matrix product in the optimized HLO"
        bad = [d for d in dots if not bench.is_s8_gemm(d)]
        assert not bad, f"{name}: dots not lowered to an s8 GEMM: {bad}"

    # one block on random words, traced: unpack fusions vs GEMM kernels
    ranged = next(iter(compiled.values()))
    key = jax.random.key(0)
    ea_d = jax.random.bits(key, (n, 4, Wpad), jnp.uint32)
    nm_d = jax.random.bits(jax.random.fold_in(key, 1), (n, Wpad), jnp.uint32)
    r0 = jnp.int32(0)
    jax.block_until_ready(ranged(ea_d, nm_d, r0))
    trace_dir = os.path.join(HERE, "_smoke", "trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(ranged(ea_d, nm_d, r0))
    wall = time.perf_counter() - t0
    del ea_d, nm_d
    times = bench.device_kernel_times(trace_dir)
    gemm = {k: v for k, v in times.items() if bench.is_gemm_kernel(k)}
    other = {k: v for k, v in times.items() if k not in gemm}
    print(f"# one block rb={rb} x {cols} cols, L={L}: traced wall {wall} s")
    for k, v in sorted(times.items(), key=lambda kv: -kv[1])[:12]:
        print(f"#   {'gemm ' if k in gemm else 'other'} {v / 1e6} ms  {k}")
    print(f"# device time: int8 GEMM {sum(gemm.values()) / 1e6} ms, "
          f"unpack and other fusions {sum(other.values()) / 1e6} ms")
    assert gemm, "no GEMM kernel in the block's trace"


def phase_main(work: str, n: int, L: int, seed: int) -> None:
    import numpy as np

    import bench
    from tracs_tpu.ops.packing import PackedAlignment, pack_fasta
    from tracs_tpu.ops.pairsnp import snp_distance_dense

    packed, fasta, dates = make_msa(work, n, L, seed, "main")
    out = os.path.join(work, "main.csv")
    t0 = time.perf_counter()
    run_distance(fasta, dates, out)
    print(f"# distance CLI {n} x {L}: {time.perf_counter() - t0} s")
    rows = read_csv(out)
    check_pairs(rows, n)
    print(f"# CSV: {len(rows)} rows, exactly the within-cluster pairs")

    ingested = pack_fasta(fasta, use_cache=False)
    assert np.array_equal(ingested.planes, packed.planes), "FASTA round trip"
    check = sorted(np.random.default_rng(seed).choice(n, size=8, replace=False))
    D_ref, NN_ref = bench.reference_rows(packed.planes, check, L)
    sub = PackedAlignment(
        planes=np.ascontiguousarray(packed.planes[check]), length=L,
        names=[packed.names[i] for i in check],
    )
    for method in ("split", "popcount"):
        D, NN = snp_distance_dense(sub, ingested, method=method)
        assert np.array_equal(D, D_ref), f"{method}: D differs from the oracle"
        assert np.array_equal(NN, NN_ref), f"{method}: NN differs from the oracle"
    where = {int(i): k for k, i in enumerate(check)}
    seen = 0
    for r in rows:
        a, b = int(r["sampleA"]), int(r["sampleB"])
        for x, y in ((a, b), (b, a)):
            if x in where:
                assert int(r["SNP distance"]) == D_ref[where[x], y], r
                assert int(r["sites considered"]) == NN_ref[where[x], y], r
                seen += 1
    print(f"# rows {check} x {n} cols equal the oracle (split and popcount); "
          f"{seen} CSV entries of those rows agree")


def phase_filter(work: str, n: int, L: int, seed: int, n_check: int = 256) -> None:
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "_recomb_oracle", os.path.join(HERE, "tests", "test_recomb.py")
    )
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)

    packed, fasta, dates = make_msa(work, n, L, seed + 1, "filter")
    out = os.path.join(work, "filter.csv")
    t0 = time.perf_counter()
    run_distance(fasta, dates, out, "--filter")
    print(f"# distance CLI --filter {n} x {L}: {time.perf_counter() - t0} s")
    rows = read_csv(out)
    check_pairs(rows, n)
    pick = np.random.default_rng(seed).choice(len(rows), size=min(n_check, len(rows)), replace=False)
    p = packed.planes
    for k in pick:
        r = rows[k]
        i, j = int(r["sampleA"]), int(r["sampleB"])
        shared = (p[i, 0] & p[j, 0]) | (p[i, 1] & p[j, 1]) | (p[i, 2] & p[j, 2]) | (p[i, 3] & p[j, 3])
        bits = np.unpackbits((~shared).view(np.uint8), bitorder="little")[:L]
        pos = np.nonzero(bits)[0]
        assert int(r["SNP distance"]) == len(pos), r
        assert int(r["filtered SNP distance"]) == oracle.oracle_filter(pos, L), r
    print(f"# {len(pick)} filtered distances equal the host oracle")


def phase_card_checks() -> None:
    spec = importlib.util.spec_from_file_location(
        "_gpu_checks", os.path.join(HERE, "tests", "gpu_checks.py")
    )
    checks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checks)
    for check in checks.CHECKS:
        check()
        print(f"# {check.__name__}: ok")


def phase_mesh(work: str, n: int, L: int, seed: int) -> None:
    _packed, fasta, dates = make_msa(work, n, L, seed, "mesh")
    outs = {}
    for spec in ("off", "4x1", "2x2"):
        outs[spec] = os.path.join(work, f"mesh_{spec}.csv")
        t0 = time.perf_counter()
        run_distance(fasta, dates, outs[spec], "--mesh", spec)
        print(f"# distance CLI --mesh {spec}: {time.perf_counter() - t0} s")
    with open(outs["off"], "rb") as fh:
        ref = fh.read()
    check_pairs(read_csv(outs["off"]), n)
    for spec in ("4x1", "2x2"):
        with open(outs[spec], "rb") as fh:
            assert fh.read() == ref, f"--mesh {spec} CSV differs from --mesh off"
        print(f"# --mesh {spec}: CSV byte-identical to --mesh off ({len(ref)} bytes)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "tracs_tpu")):
        raise SystemExit("chip_smoke: run it from a checkout (tracs_tpu/ not found)")
    sys.path.insert(0, HERE)
    # the MSAs are generated anew each run: caching their packed planes
    # would only write gigabytes under $HOME
    os.environ.setdefault("TRACS_TPU_PACK_CACHE", "0")

    import jax

    import tracs_tpu
    from bench import gpu_name_and_power_limit
    from tracs_tpu.runtime import native

    devices = require_gpu()
    if len(devices) < args.cards:
        raise SystemExit(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
                         f"JAX found {len(devices)}")
    card = gpu_name_and_power_limit()
    label = card.splitlines()[0]
    print(card)
    print(f"# jax {jax.__version__}; devices {devices}; "
          f"device_kind {devices[0].device_kind!r}")
    lib = native.get_lib()
    print(f"# native library: {native.LOADED[0] if lib else 'not loaded'} "
          f"({'built in this run' if lib and native.LOADED[1] else 'already built' if lib else 'numpy fallback'})")
    print(f"# compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"# tracs_tpu from {os.path.dirname(tracs_tpu.__file__)}")

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        print(f"# --- {name}", flush=True)
        yield
        print(f"# {name}: {time.perf_counter() - t0} s set-up time on {label}",
              flush=True)

    n, L = 4096, 1_000_000
    work = os.path.join(HERE, "_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        if args.cards == 4:
            with phase("mesh 4x1 and 2x2 vs off"):
                phase_mesh(work, n, L, args.seed)
        else:
            with phase("phase 1: compile and lower the grams"):
                phase_compile(n, L, rb=1024)
            with phase("phase 2: distance CLI at 4096 x 1 Mb"):
                phase_main(work, n, L, args.seed)
            with phase("phase 3: distance CLI --filter at 1024 x 1 Mb"):
                phase_filter(work, 1024, L, args.seed)
            with phase("phase 4: card-only checks"):
                phase_card_checks()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
