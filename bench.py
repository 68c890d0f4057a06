"""Benchmark helpers and the headline all-pairs benchmark.

Workload: n samples x 1 Mb genomes, streamed through the production unit —
``pairsnp_stream``'s per-block device sweep (split-decomposition int8
grams), device-side threshold + survivor count, device-side COO compaction,
and the host download/assembly of the surviving (row, col, d, nn) entries.
The synthetic alignment has cluster structure so ~0.5% of pairs fall under
the SNP threshold, and the sparse-download path does real work.

The reference publishes no numbers (BASELINE.md), so vs_baseline is the
speedup over a numpy realisation of the reference's kernel (bit-packed
AND/OR + popcount, ``reference_rows``), scaled to all host cores — an
optimistic stand-in for the OpenMP loop in reference src/pairsnp.hpp:380-421.

Prints the device (platform, device_kind, count, power limit) and then ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "mfu", "device", ...}.
``mfu`` is the fraction of the card's dense int8 peak (``INT8_PEAK_OPS``)
reached by the sweep's gram MACs (5 int8 MACs/site/pair); it is null on a
device that has no published peak here, such as the CPU.

Also kept here, for chip_smoke.py and later benchmarks: the data
generators, a FASTA writer, the numpy oracle, the classifier that reads
which implementation each matrix product got in an optimized HLO module,
and the reduction from a profiler trace to per-kernel device time.
"""

import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

#: Dense int8 tensor-core peak in ops/s, keyed by ``jax.Device.device_kind``
#: (NVIDIA H100 Tensor Core GPU data sheet, without sparsity; the rates
#: assume the card's full power limit).
INT8_PEAK_OPS = {
    "NVIDIA H100 80GB HBM3": 1979e12,  # SXM5
    "NVIDIA H100 PCIe": 1513e12,
}


def int8_peak_ops(platform: str, device_kind: str) -> float | None:
    """The dense int8 peak of a device, None on the CPU; an accelerator
    missing from INT8_PEAK_OPS is an error, never a default."""
    if platform == "cpu":
        return None
    try:
        return INT8_PEAK_OPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no int8 peak recorded for device kind {device_kind!r}; "
            "add it to bench.INT8_PEAK_OPS with its source"
        ) from None


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line
    ("not available" where nvidia-smi is missing or fails)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return r.stdout.strip() if r.returncode == 0 else "not available"


def device_info() -> dict:
    """What every benchmark result is labelled with."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "power_limit": gpu_name_and_power_limit() if d.platform == "gpu" else None,
    }


def _random_planes(n, L, seed=0):
    """n random packed 4-plane samples with realistic composition: ~86%
    unambiguous calls, 14% N (low coverage).  Partial IUPAC codes are NOT
    drawn here: in real data they appear only at shared polymorphic
    columns (make_clustered injects them there); independent per-sample
    partial sites would union to ~the whole genome across n samples and
    blow the partial-correction gram up to 10 channels x L — a shape no
    real alignment produces.

    Samples are cut from ONE random site pool at 32-site offsets: RNG cost
    is O(L) instead of O(n*L).  Composition quantised to 1/256 via a LUT.
    """
    from tracs_tpu.ops.packing import nibbles_to_planes

    rng = np.random.default_rng(seed)
    probs = np.array([0.215] * 4 + [0.14])
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    counts = np.diff(np.round(np.concatenate([[0.0], np.cumsum(probs)]) * 256))
    lut = np.repeat(codes, counts.astype(np.int64))
    assert lut.shape == (256,)

    pool_L = L + 32 * n
    nib = lut[rng.integers(0, 256, size=pool_L, dtype=np.uint8)]
    pool_planes = nibbles_to_planes(nib[None, :])[0]  # [4, Wp]
    W = (L + 31) // 32
    planes = np.empty((n, 4, W), dtype=np.uint32)
    for i in range(n):
        planes[i] = pool_planes[:, i : i + W]
    tail = W * 32 - L
    if tail:
        planes[:, :, -1] &= np.uint32(0xFFFFFFFF >> tail)
    return planes


def _mutate_inplace(planes, positions, rng):
    """Point-mutate one sample's packed planes: at each position clear all
    four base bits, then set one random base (unambiguous substitution)."""
    w = (positions // 32).astype(np.int64)
    b = (positions % 32).astype(np.uint32)
    clear = ~(np.uint32(1) << b)
    setb = np.uint32(1) << b
    for c in range(4):
        np.bitwise_and.at(planes[c], w, clear)
    newbase = rng.integers(0, 4, size=positions.shape[0])
    np.bitwise_or.at(planes, (newbase, w), setb)


def make_clustered(n, L, cluster_size=6, max_mut=90, n_partial_cols=2048, seed=0):
    """Alignment with transmission-cluster structure: n/cluster_size base
    genomes (mutually ~random, SNP distance ~0.4L), each cluster member an
    independently mutated copy of its base (5..max_mut substitutions).
    Within-cluster pair distances land in [~10, ~160]; with a SNP
    threshold of 200 every within-cluster pair survives and nothing else:
    survivor fraction = (cluster_size-1)/(n-1) ~ 0.5% at the defaults.

    ``n_partial_cols`` shared columns additionally carry partial IUPAC
    codes (mixed-strain evidence) in every sample — codes M (A|C) and R
    (A|G), whose intersections always share the A bit, so the
    partial-correction gram is exercised without perturbing distances.
    """
    from tracs_tpu.ops.packing import PackedAlignment

    n_clusters = (n + cluster_size - 1) // cluster_size
    bases = _random_planes(n_clusters, L, seed=seed)
    rng = np.random.default_rng(seed + 1)
    max_mut = min(max_mut, max(5, L // 16))  # tiny-genome (test) safety
    n_partial_cols = min(n_partial_cols, L // 8)
    planes = np.empty((n, 4, bases.shape[2]), dtype=np.uint32)
    for i in range(n):
        planes[i] = bases[i // cluster_size]
        k = int(rng.integers(min(5, max_mut), max_mut + 1))
        pos = rng.choice(L, size=k, replace=False)
        _mutate_inplace(planes[i], pos, rng)
    if n_partial_cols:
        cols = rng.choice(L, size=n_partial_cols, replace=False)
        w = (cols // 32).astype(np.int64)
        setb = np.uint32(1) << (cols % 32).astype(np.uint32)
        clear = ~setb
        for i in range(n):
            is_m = rng.integers(0, 2, size=n_partial_cols) == 0  # M else R
            for c in range(4):
                np.bitwise_and.at(planes[i, c], w, clear)
            np.bitwise_or.at(planes[i, 0], w, setb)  # A bit in both codes
            np.bitwise_or.at(planes[i, 1], w[is_m], setb[is_m])
            np.bitwise_or.at(planes[i, 2], w[~is_m], setb[~is_m])
    return PackedAlignment(
        planes=planes, length=L, names=[str(i) for i in range(n)]
    )



def write_fasta(packed, path, batch=64):
    """Write a PackedAlignment as plain IUPAC FASTA (records named by
    ``packed.names``), unpacking ``batch`` samples at a time."""
    lut = np.frombuffer(b"-ACMGRSVTWYHKDBN", dtype=np.uint8)
    n, L = packed.n_seqs, packed.length
    with open(path, "wb") as fh:
        for s in range(0, n, batch):
            words = np.ascontiguousarray(packed.planes[s : s + batch])
            bits = np.unpackbits(
                words.view(np.uint8), axis=-1, bitorder="little"
            )[..., :L]  # [b, 4, L], bit k of plane c = allele c at site k
            nib = bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2) | (bits[:, 3] << 3)
            for name, row in zip(packed.names[s : s + batch], lut[nib]):
                fh.write(b">%s\n" % name.encode())
                fh.write(row.tobytes())
                fh.write(b"\n")


def write_dates(names, path, seed=7):
    """A ``name,date`` metadata CSV with seed-chosen sampling dates over ten
    years from 2015-01-01."""
    from datetime import date, timedelta

    days = np.random.default_rng(seed).integers(0, 3650, size=len(names))
    base = date(2015, 1, 1)
    with open(path, "w") as fh:
        fh.write("name,date\n")
        for name, d in zip(names, days):
            fh.write(f"{name},{(base + timedelta(days=int(d))).isoformat()}\n")


def reference_rows(planes, rows, length):
    """(D, NN) int64 [len(rows), n] for the given rows of packed planes
    [n, 4, W] uint32: the reference's inner loop (pairsnp.hpp:395-421) in
    numpy — a site matches when the two samples share an allele bit,
    D = L - matches; NN = L - popcount(N_i | N_j), N = all four bits."""
    planes = np.asarray(planes)
    n_all = planes[:, 0] & planes[:, 1] & planes[:, 2] & planes[:, 3]
    D = np.empty((len(rows), planes.shape[0]), dtype=np.int64)
    NN = np.empty_like(D)
    for k, i in enumerate(rows):
        shared = planes[i, 0][None, :] & planes[:, 0]
        shared |= planes[i, 1][None, :] & planes[:, 1]
        shared |= planes[i, 2][None, :] & planes[:, 2]
        shared |= planes[i, 3][None, :] & planes[:, 3]
        D[k] = length - np.bitwise_count(shared).sum(axis=1)
        NN[k] = length - np.bitwise_count(n_all[i][None, :] | n_all).sum(axis=1)
    return D, NN


# ---------------------------------------------------------------------------
# optimized-HLO reading: which implementation did each matrix product get
# ---------------------------------------------------------------------------

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\((.*)$")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_SHAPE = re.compile(r"([a-z]+\d*)\[([\d,]*)\]")


def _args(text: str) -> list[str]:
    """Top-level comma-separated operands of ``text`` (after the opening
    parenthesis), up to its matching close."""
    depth, cur, out = 0, [], []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            if depth == 0:
                break
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def dot_lowerings(hlo_text: str) -> list[dict]:
    """Every matrix product of an optimized HLO module, with how it is
    implemented: ``{"impl", "lhs", "rhs", "out"}`` where impl is
    ``"cublas"`` (a cuBLAS/cuBLASLt GEMM custom call), ``"triton"`` (a
    dot inside a Triton GEMM fusion) or ``"other"`` (a dot XLA emits
    itself, e.g. a loop).  lhs/rhs/out are HLO types such as
    ``"s8[1024,262144]"``."""
    comps: dict[str, list[tuple[str, str, str, str]]] = {}
    types: dict[str, str] = {}
    cur = None
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m and cur is not None:
            name, typ, op, rest = m.groups()
            types[name] = typ
            comps[cur].append((name, typ, op, rest))
            continue
        c = _COMP.match(line)
        if c and "=" not in line.split("{")[0]:
            cur = c.group(1)
            comps.setdefault(cur, [])

    def operand_type(arg: str) -> str:
        sm = _SHAPE.search(arg)
        if sm and not arg.lstrip().startswith("%"):
            return f"{sm.group(1)}[{sm.group(2)}]"
        ref = arg.split()[-1].lstrip("%")
        sm = _SHAPE.search(types.get(ref, ""))
        return f"{sm.group(1)}[{sm.group(2)}]" if sm else "?"

    def first_type(typ: str) -> str:
        sm = _SHAPE.search(typ)
        return f"{sm.group(1)}[{sm.group(2)}]" if sm else "?"

    def called(rest: str) -> list[str]:
        return re.findall(r"(?:calls|to_apply)=%?([\w.\-]+)", rest)

    triton_comps: set[str] = set()
    out = []
    for comp, instrs in comps.items():
        for name, typ, op, rest in instrs:
            if op == "custom-call" and re.search(r'custom_call_target="__cublas', rest):
                a = _args(rest)
                out.append({"impl": "cublas", "lhs": operand_type(a[0]),
                            "rhs": operand_type(a[1]), "out": first_type(typ)})
            elif op == "fusion" and re.search(r'"kind":"__triton(_nested)?_gemm', rest):
                stack = called(rest)
                while stack:
                    c = stack.pop()
                    if c not in triton_comps:
                        triton_comps.add(c)
                        for _n, _t, _o, r in comps.get(c, []):
                            stack.extend(called(r))
    for comp, instrs in comps.items():
        for name, typ, op, rest in instrs:
            if op == "dot":
                a = _args(rest)
                out.append({
                    "impl": "triton" if comp in triton_comps else "other",
                    "lhs": operand_type(a[0]), "rhs": operand_type(a[1]),
                    "out": first_type(typ),
                })
    return out


# ---------------------------------------------------------------------------
# profiler trace -> device time per kernel
# ---------------------------------------------------------------------------

def is_s8_gemm(dot: dict) -> bool:
    """Whether a ``dot_lowerings`` entry is a GEMM library call or Triton
    GEMM fusion with int8 operands."""
    return (dot["impl"] in ("cublas", "triton")
            and dot["lhs"].startswith("s8[") and dot["rhs"].startswith("s8["))


_GEMM_KERNEL = re.compile(r"gemm|cublas|cutlass|xmma|imma|matmul", re.I)


def is_gemm_kernel(name: str) -> bool:
    """Whether a GPU kernel name is a matrix-multiply kernel: a cuBLAS or
    CUTLASS GEMM, or an XLA Triton GEMM fusion."""
    return bool(_GEMM_KERNEL.search(name))


def device_kernel_times(trace_dir: str) -> dict[str, int]:
    """Total device nanoseconds per kernel name, summed over every GPU
    plane of the newest ``.xplane.pb`` under ``trace_dir``."""
    import glob

    from jax.profiler import ProfileData

    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    totals: dict[str, int] = collections.Counter()
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                totals[ev.name] += int(ev.duration_ns)
    return dict(totals)


def bench_device(n=4096, L=1_000_000, iters=5, snp_threshold=200):
    """Times the full production streaming unit (what ``tracs-tpu
    distance`` runs per row block): device sweep -> device threshold +
    survivor count -> device COO compaction -> host download of the
    surviving (row, col, d, nn) entries.  Survivors are ~0.5-1% of pairs
    by construction, so the sparse-download branch and the NN gathers are
    inside the timed region.  Variant-site compaction is off: every column
    of the synthetic alignment is variant (random base genomes), so the
    scan would find nothing to drop.

    row_block < n engages the prefix-triangle schedule (each row block
    sweeps only columns >= its first row).  The row block defaults to
    max(1024, min(2048, n // 4)); BENCH_RB overrides it.  Neither was
    tuned on the H100 (not measured).
    """
    from tracs_tpu.ops.pairsnp import pairsnp_stream, schedule_mac_pairs

    info = device_info()
    peak = int8_peak_ops(info["platform"], info["kind"])
    # scale cluster size so within-cluster (surviving) pairs stay ~0.5% of
    # all pairs at any n: (cs-1)/(n-1) ~ 0.005
    cluster_size = max(6, round(0.005 * n) + 1)
    packed = make_clustered(n, L, cluster_size=cluster_size)
    row_block = int(os.environ.get("BENCH_RB", str(max(1024, min(2048, n // 4)))))

    def consume():
        pairs = 0
        for _r0, _r1, _names, rows, _c, _d, _f, _nn in pairsnp_stream(
            [packed], dist=snp_threshold, compact=False, row_block=row_block
        ):
            pairs += len(rows)
        return pairs

    # Warmup 1: upload + compile.  Warmup 2: settle any state-dependent
    # shape variants (extraction capacities are sticky per shape).  Each
    # consume() downloads every block's packed survivors, so it is
    # device-synchronous by construction.
    t0 = time.time()
    consume()
    print(f"# warmup(upload+compile): {time.time() - t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    consume()
    print(f"# warmup(settle): {time.time() - t0:.3f}s", file=sys.stderr)
    # per-sweep wall times with absolute timestamps, so one slow sweep is
    # visible in the record; the median is the headline
    sweep_s = []
    for k in range(iters):
        t0 = time.time()
        survivors = consume()
        sweep_s.append(time.time() - t0)
        print(
            f"# sweep {k} @{time.strftime('%H:%M:%S')}: {sweep_s[-1]}s",
            file=sys.stderr,
        )
    dt = float(np.median(sweep_s))
    rate = n * n / dt
    # 5 int8 MACs/site/pair (4 exclusive-base channels + 1 N channel), 2
    # ops per MAC, over the MACs the schedule in effect actually executes
    triangle = os.environ.get("TRACS_TPU_TRIANGLE", "1") != "0"
    mac_pairs = schedule_mac_pairs(n, row_block, triangle=triangle)
    mfu = None if peak is None else (2.0 * 5 * mac_pairs * L / dt) / peak
    print(
        f"# stream unit: {dt}s/sweep, {survivors} survivors -> {rate} pairs/s",
        file=sys.stderr,
    )
    return rate, mfu, dt, min(sweep_s), info


def bench_cpu_reference(n_rows=8, n=256, L=1_000_000):
    """Host pairs/s of ``reference_rows`` on random planes, scaled to all
    cores (an optimistic linear-scaling OpenMP stand-in)."""
    rng = np.random.default_rng(0)
    planes = rng.integers(0, 2**32, size=(n, 4, (L + 31) // 32), dtype=np.uint32)
    t0 = time.time()
    reference_rows(planes, range(n_rows), L)
    dt = time.time() - t0
    single_thread = n_rows * n / dt
    ncores = os.cpu_count() or 1
    rate = single_thread * ncores
    print(
        f"# cpu reference: {single_thread} pairs/s/core x {ncores} cores "
        f"= {rate} pairs/s",
        file=sys.stderr,
    )
    return rate


def main():
    n = int(os.environ.get("BENCH_N", "4096"))
    L = int(os.environ.get("BENCH_L", "1000000"))
    rate, mfu, dt_med, dt_min, info = bench_device(n=n, L=L)
    print(
        f"# device: {info['platform']} {info['kind']} x{info['count']}, "
        f"power limit {info['power_limit']}",
        file=sys.stderr,
    )
    cpu_rate = bench_cpu_reference(n=n, L=L)
    print(
        json.dumps(
            {
                "metric": "pairwise comparisons/sec/device (streamed all-pairs SNP dist + COO, 1Mb genomes)",
                "value": rate,
                "unit": "pairs/s",
                "vs_baseline": rate / cpu_rate,
                "mfu": mfu,
                "sweep_s_median": dt_med,
                "sweep_s_min": dt_min,
                "device": info,
            }
        )
    )


if __name__ == "__main__":
    main()
