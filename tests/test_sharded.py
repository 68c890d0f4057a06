"""Sharded vs single-device bit-equality on a forced 8-device CPU mesh —
the multi-chip test strategy SURVEY.md §4 calls for (the reference has no
distributed code to test)."""

import numpy as np
import pytest
import jax

from tracs_tpu.ops.packing import pack_sequences
from tracs_tpu.ops.pairsnp import snp_distance_dense
from tracs_tpu.parallel.allpairs import sharded_snp_distance
from tracs_tpu.parallel.mesh import best_mesh_shape, make_mesh


requires_8dev = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 forced CPU devices"
)


def _random_packed(rng, n, L):
    chars = np.array(list("ACGTMRWSYKVHDBN"))
    seqs = ["".join(rng.choice(chars, size=L)) for _ in range(n)]
    return pack_sequences(seqs)


@requires_8dev
@pytest.mark.parametrize(
    "dp,sp",
    [
        (8, 1), (4, 2), (2, 4), (1, 8), (2, 2),
        # odd dp exercises the triangle schedule's mirror-every-step branch
        # (allpairs.py: n_dp % 2 == 1) over a device subset
        (3, 1), (5, 1), (7, 1), (3, 2),
    ],
)
def test_ring_matches_dense(rng, dp, sp):
    packed = _random_packed(rng, 13, 401)  # deliberately non-multiples
    D0, NN0 = snp_distance_dense(packed)
    mesh = make_mesh(dp, sp)
    D1, NN1 = sharded_snp_distance(packed, mesh)
    assert np.array_equal(D0, D1)
    assert np.array_equal(NN0, NN1)


@requires_8dev
def test_ring_single_sample_block(rng):
    # fewer samples than dp ranks: heavy padding path
    packed = _random_packed(rng, 3, 100)
    D0, _ = snp_distance_dense(packed)
    D1, _ = sharded_snp_distance(packed, make_mesh(8, 1))
    assert np.array_equal(D0, D1)


def test_best_mesh_shape():
    assert best_mesh_shape(1) == (1, 1)
    assert best_mesh_shape(8, n_samples=10000) == (8, 1)
    dp, sp = best_mesh_shape(8, n_samples=4)
    assert dp * sp == 8 and dp <= 2


@requires_8dev
def test_ring_with_compaction(rng):
    # conserved backbone -> compaction triggers; sharded compact == dense full
    base = rng.choice(np.array(list("ACGT")), size=500)
    seqs = []
    for _ in range(11):
        s = base.copy()
        idx = rng.choice(500, size=12, replace=False)
        s[idx] = rng.choice(np.array(list("ACGTN")), size=12)
        seqs.append("".join(s))
    packed = pack_sequences(seqs)
    from tracs_tpu.ops.packing import compact_variant_columns

    assert compact_variant_columns(packed) is not None  # it does trigger
    D0, NN0 = snp_distance_dense(pack_sequences(seqs))  # fresh: no cache
    D1, NN1 = sharded_snp_distance(packed, make_mesh(4, 2), compact=True)
    assert np.array_equal(D0, D1)
    assert np.array_equal(NN0, NN1)


# ---------------------------------------------------------------------------
# production streaming path: pairsnp_stream / distance stage on a mesh
# ---------------------------------------------------------------------------


@requires_8dev
@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (3, 2), (5, 1)])
def test_stream_on_mesh_matches_single_device(rng, dp, sp):
    from tracs_tpu.ops.pairsnp import pairsnp

    seqs = _random_seqs(rng, 13, 401)
    base = pairsnp([pack_sequences(seqs)], dist=120, row_block=5)
    on_mesh = pairsnp(
        [pack_sequences(seqs)], dist=120, row_block=5, mesh=make_mesh(dp, sp)
    )
    for x, y in zip(base, on_mesh):
        assert list(x) == list(y)


@requires_8dev
def test_ring_hbm_budget_falls_back_to_sweep(rng, monkeypatch):
    """Runs whose per-device stripe tensors exceed TRACS_TPU_RING_BYTES must
    route through the block-streamed ShardedSweep (ADVICE r2: RingCoo's
    stripes are O(n^2/n_dp) HBM regardless of --row-block) with identical
    output."""
    import tracs_tpu.parallel.allpairs as ap
    from tracs_tpu.ops.pairsnp import pairsnp

    mesh = make_mesh(4, 2)
    assert ap.RingCoo.stripe_bytes(13, mesh) == 4 * 4 * 16 * 4
    seqs = _random_seqs(rng, 13, 401)
    base = pairsnp([pack_sequences(seqs)], dist=120, row_block=5)

    made_ring = []
    real_init = ap.RingCoo.__init__
    monkeypatch.setattr(
        ap.RingCoo, "__init__",
        lambda self, *a, **k: (made_ring.append(1), real_init(self, *a, **k))[1],
    )
    monkeypatch.setenv("TRACS_TPU_RING_BYTES", "1")  # force over-budget
    over = pairsnp(
        [pack_sequences(seqs)], dist=120, row_block=5, mesh=mesh
    )
    assert not made_ring  # fell back to ShardedSweep
    for x, y in zip(base, over):
        assert list(x) == list(y)


@requires_8dev
def test_stream_on_mesh_rectangle(rng):
    # 2-fasta query-vs-db block sweep on the mesh, incl. IUPAC partials
    from tracs_tpu.ops.pairsnp import pairsnp

    A = pack_sequences(_random_seqs(rng, 6, 300))
    B = pack_sequences(_random_seqs(rng, 9, 300))
    base = pairsnp([A, B], dist=10**9)
    on_mesh = pairsnp([A, B], dist=10**9, mesh=make_mesh(4, 2), row_block=4)
    for x, y in zip(base, on_mesh):
        assert list(x) == list(y)


@requires_8dev
def test_stream_on_mesh_with_filter(rng):
    from tracs_tpu.ops.pairsnp import pairsnp

    seqs = _random_seqs(rng, 9, 500, chars="ACGT")
    base = pairsnp([pack_sequences(seqs)], dist=10**9, filter=True)
    on_mesh = pairsnp(
        [pack_sequences(seqs)], dist=10**9, filter=True,
        mesh=make_mesh(8, 1), row_block=3,
    )
    for x, y in zip(base, on_mesh):
        assert list(x) == list(y)


@requires_8dev
def test_stream_on_mesh_resume_mid_matrix(rng):
    """start_row > 0 on a mesh (the --resume path) routes through the
    per-block ShardedSweep and must emit exactly the single-device tail."""
    from tracs_tpu.ops.pairsnp import pairsnp_stream

    def collect(stream):
        out = [[], [], [], [], []]
        for _r0, _r1, _nm, r, c, d, f, nn in stream:
            out[0] += list(r); out[1] += list(c); out[2] += list(d)
            out[3] += list(f); out[4] += list(nn)
        return out

    packed = pack_sequences(_random_seqs(rng, 11, 350))
    base = collect(pairsnp_stream([packed], dist=150, row_block=3, start_row=6))
    on_mesh = collect(pairsnp_stream(
        [packed], dist=150, row_block=3, start_row=6, mesh=make_mesh(4, 2)
    ))
    assert base == on_mesh


@requires_8dev
def test_distance_stage_csv_identical_on_mesh(rng, tmp_path):
    # the VERDICT 'done' criterion: the *stage* produces a byte-identical
    # CSV on a dp x sp mesh vs single-device
    import argparse
    import gzip

    from tracs_tpu.stages.distance import distance as distance_stage, distance_parser

    seqs = _random_seqs(rng, 11, 257)
    msa = tmp_path / "toy.fasta.gz"
    with gzip.open(msa, "wt") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i}\n{s}\n")
    meta = tmp_path / "dates.csv"
    with open(meta, "w") as fh:
        fh.write("name,date\n")
        for i in range(len(seqs)):
            fh.write(f"s{i},2021-03-{(i % 27) + 1:02d}\n")

    def run(mesh_spec, out):
        parser = distance_parser(argparse.ArgumentParser())
        args = parser.parse_args(
            ["--msa", str(msa), "--meta", str(meta), "-o", str(out),
             "--filter", "--mesh", mesh_spec, "--row-block", "4"]
        )
        distance_stage(args)
        return out.read_text()

    csv_mesh = run("4x2", tmp_path / "mesh.csv")
    csv_single = run("off", tmp_path / "single.csv")
    assert csv_mesh == csv_single
    assert len(csv_mesh.splitlines()) == 1 + 11 * 10 // 2


def _random_seqs(rng, n, L, chars="ACGTMRWSYKVHDBN"):
    arr = np.array(list(chars))
    return ["".join(rng.choice(arr, size=L)) for _ in range(n)]


@requires_8dev
def test_ring_and_stream_with_forced_chunking(rng, monkeypatch):
    # a tiny HBM budget forces n_chunks > 1 inside every shard_map body —
    # the word-chunk loop (optimization_barrier serialisation) must not
    # change any value.  This is the memory-bounded big-shape sweep check
    # scaled down: the same planner (plan_chunks) bounds the north-star
    # 1250-sample x 1 Mb per-device blocks.
    from tracs_tpu.ops.pairsnp import pairsnp, plan_chunks

    seqs = _random_seqs(rng, 13, 4001)
    D0, NN0 = snp_distance_dense(pack_sequences(seqs))
    monkeypatch.setenv("TRACS_TPU_CHUNK_BYTES", str(1 << 12))
    wc, n_chunks = plan_chunks(26, 5, (4001 + 31) // 32)
    assert n_chunks > 1  # the budget really does force chunking
    D1, NN1 = sharded_snp_distance(pack_sequences(seqs), make_mesh(4, 2))
    assert np.array_equal(D0, D1) and np.array_equal(NN0, NN1)

    from tracs_tpu.ops.pairsnp import pairsnp

    base = pairsnp([pack_sequences(seqs)], dist=3000, row_block=5)
    on_mesh = pairsnp(
        [pack_sequences(seqs)], dist=3000, row_block=5, mesh=make_mesh(2, 4)
    )
    for x, y in zip(base, on_mesh):
        assert list(x) == list(y)


def test_plan_chunks_budget_accounting():
    # north-star shape: 10k samples over 8 dp ranks -> 1250-row blocks vs
    # 1250-row DB shards, 1 Mb genomes.  The planned chunk's materialised
    # int8 channels (2 bytes/site/channel/row) must fit the budget.
    from tracs_tpu.ops.pairsnp import plan_chunks
    from tracs_tpu.runtime.memory import memory_budgets

    rows, channels = 2 * 1250, 5
    W = (1_000_000 + 31) // 32
    wc, n_chunks = plan_chunks(rows, channels, W)
    assert wc * 32 * rows * channels * 2 <= memory_budgets().chunk
    assert n_chunks == -(-W // wc)
    # and chunks stay lane-aligned
    assert wc % 256 == 0 or wc == W or wc <= 256


# ---------------------------------------------------------------------------
# RingCoo fallback branches under realistic survivor distributions
# (VERDICT r3 item 5)
# ---------------------------------------------------------------------------


def _clustered_seqs(rng, n, L, cluster_size, n_mut=6):
    """Transmission-cluster structure: within-cluster pairs differ by at
    most 2*n_mut sites, cross-cluster pairs by ~0.75*L — so a small SNP
    threshold keeps exactly the within-cluster pairs."""
    chars = np.array(list("ACGT"))
    n_bases = (n + cluster_size - 1) // cluster_size
    bases = [rng.choice(chars, size=L) for _ in range(n_bases)]
    seqs = []
    for i in range(n):
        s = bases[i // cluster_size].copy()
        idx = rng.choice(L, size=n_mut, replace=False)
        s[idx] = rng.choice(chars, size=n_mut)
        seqs.append("".join(s))
    return seqs


def _spy_reextraction(monkeypatch):
    import tracs_tpu.ops.pairsnp as pp

    calls = []
    real = pp._stream_block_sparse

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pp, "_stream_block_sparse", spy)
    return calls


@requires_8dev
def test_ring_capacity_overflow_reextracts(rng, monkeypatch):
    """Survivor count above the stripe capacity (clustered data, ~24%
    density vs a forced tiny buffer) must take the full-capacity
    re-extraction fallback with byte-identical output."""
    import tracs_tpu.ops.pairsnp as pp
    import tracs_tpu.parallel.allpairs as ap
    from tracs_tpu.ops.pairsnp import pairsnp

    monkeypatch.setattr(pp, "_SURVIVOR_DENSITY_HINT", [None])
    seqs = _clustered_seqs(rng, 96, 500, 24)
    base = pairsnp([pack_sequences(seqs)], dist=30, row_block=7)
    assert len(base[0]) == 4 * (24 * 23 // 2)  # the expected survivor set

    calls = _spy_reextraction(monkeypatch)
    real_init = ap.RingCoo.__init__

    def tiny_cap(self, *a, **k):
        real_init(self, *a, **k)
        self.capacity = 64  # << 276 survivors in the first stripe

    monkeypatch.setattr(ap.RingCoo, "__init__", tiny_cap)
    over = pairsnp([pack_sequences(seqs)], dist=30, mesh=make_mesh(4, 2))
    assert calls  # the overflow branch actually ran
    for x, y in zip(base, over):
        assert list(x) == list(y)


@requires_8dev
def test_ring_dense_stripe_reextracts(rng, monkeypatch):
    """A dense stripe (near-identical samples: every pair survives, so
    2*count exceeds the stripe) must also route through the re-extraction
    branch and stay byte-identical."""
    import tracs_tpu.ops.pairsnp as pp
    from tracs_tpu.ops.pairsnp import pairsnp

    monkeypatch.setattr(pp, "_SURVIVOR_DENSITY_HINT", [None])
    seqs = _clustered_seqs(rng, 40, 300, 40, n_mut=2)  # one cluster
    base = pairsnp([pack_sequences(seqs)], dist=30, row_block=7)
    assert len(base[0]) == 40 * 39 // 2  # fully dense

    calls = _spy_reextraction(monkeypatch)
    over = pairsnp([pack_sequences(seqs)], dist=30, mesh=make_mesh(4, 2))
    assert calls
    for x, y in zip(base, over):
        assert list(x) == list(y)


@requires_8dev
def test_survivor_density_hint_feeds_next_run(rng, monkeypatch):
    """A completed stream records its survivor density; the next ring run
    sizes stripe capacities from it (2x margin)."""
    import tracs_tpu.ops.pairsnp as pp
    import tracs_tpu.parallel.allpairs as ap
    from tracs_tpu.ops.pairsnp import pairsnp

    monkeypatch.setattr(pp, "_SURVIVOR_DENSITY_HINT", [None])
    seqs = _clustered_seqs(rng, 96, 500, 24)
    hints = []
    real_init = ap.RingCoo.__init__

    def spy(self, *a, **k):
        hints.append(k.get("density_hint"))
        real_init(self, *a, **k)

    monkeypatch.setattr(ap.RingCoo, "__init__", spy)
    mesh = make_mesh(4, 2)
    r1 = pairsnp([pack_sequences(seqs)], dist=30, mesh=mesh)
    want = len(r1[0]) / (96 * 95 // 2)
    assert pp._SURVIVOR_DENSITY_HINT[0] == pytest.approx(want)
    r2 = pairsnp([pack_sequences(seqs)], dist=30, mesh=mesh)
    assert hints == [None, pytest.approx(want)]
    for x, y in zip(r1, r2):
        assert list(x) == list(y)


def test_plan_capacity_sizing():
    from tracs_tpu.parallel.allpairs import RingCoo

    # blind default: ~1/64 of the stripe, floored at one small transfer
    assert RingCoo.plan_capacity(1024, 8192, None) == 1024 * 8192 // 64
    assert RingCoo.plan_capacity(8, 64, None) == 1 << 14
    # measured density: 2x margin beats the blind default when denser
    dense = RingCoo.plan_capacity(1024, 8192, 0.05)
    assert dense == int(2 * 0.05 * 1024 * 8192) + 1
    assert dense > RingCoo.plan_capacity(1024, 8192, None)
