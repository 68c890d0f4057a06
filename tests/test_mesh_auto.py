"""HBM/genome-length-aware auto mesh selection (VERDICT r3 item 4).

best_mesh_shape's policy: all-dp while triangle stripes stay fat enough
(>= _MIN_STRIPE_ROWS rows) to hide ring traffic; below that, devices go
to sp (position shards), capped so a shard never drops under 8 packed
words; shapes whose ring stripes would blow the ring-stripe budget are avoided
when a feasible shape exists.  RingCoo.fits additionally accounts the
resident operand bytes when given the word count, so long-genome runs
fall back to the block-streamed ShardedSweep instead of OOMing mid-ring.
"""

import gzip
import os

import numpy as np
import pytest
import jax

from tracs_tpu.ops.packing import pack_sequences
from tracs_tpu.parallel.mesh import best_mesh_shape, make_mesh, resolve_mesh

requires_8dev = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 forced CPU devices"
)

MB_WORDS = 31250  # 1 Mb genome in packed uint32 words


def test_shape_policy_grid():
    # sample-rich 1 Mb runs keep every device as a dp stripe
    assert best_mesh_shape(8, n_samples=10000, n_words=MB_WORDS) == (8, 1)
    # medium n: all-dp stripes would be 256 rows — too thin to hide the
    # ring's operand rotation — so half the devices shard positions
    assert best_mesh_shape(8, n_samples=2048, n_words=MB_WORDS) == (4, 2)
    # small n, long genome: one fat stripe, all surplus to sp
    assert best_mesh_shape(8, n_samples=512, n_words=MB_WORDS) == (1, 8)
    # short genome caps sp: 16 words allow at most 2 position shards
    assert best_mesh_shape(8, n_samples=4, n_words=16) == (4, 2)
    # unknown dims keep the dimension-free defaults
    assert best_mesh_shape(8) == (8, 1)
    assert best_mesh_shape(1, n_samples=5, n_words=10) == (1, 1)


def test_shape_policy_invariants():
    for n_dev in (2, 4, 6, 8):
        for n in (2, 7, 100, 5000, 300000):
            for w in (8, 400, MB_WORDS, 4 * MB_WORDS):
                dp, sp = best_mesh_shape(n_dev, n_samples=n, n_words=w)
                assert dp * sp == n_dev
                assert sp <= max(1, w // 8)


def test_shape_respects_ring_budget():
    # n large enough that no dp<=8 keeps stripes under the ring budget:
    # the planner still returns all-dp (stripe-minimal; the streaming
    # engine takes over from the ring at run time)
    assert best_mesh_shape(8, n_samples=300000, n_words=MB_WORDS) == (8, 1)
    # at n=40000 only dp>=4 fits the 4 GiB default budget (16*n^2/dp):
    # a thin-stripe concession to sp must not pick dp=1
    dp, sp = best_mesh_shape(8, n_samples=40000, n_words=MB_WORDS)
    assert 16 * 40000 * (-(-40000 // dp)) <= 4 << 30


@requires_8dev
def test_resolve_mesh_uses_dims():
    mesh = resolve_mesh("auto", n_samples=2048, n_words=MB_WORDS)
    assert dict(mesh.shape) == {"dp": 4, "sp": 2}
    mesh = resolve_mesh("auto", n_samples=10000, n_words=MB_WORDS)
    assert dict(mesh.shape) == {"dp": 8, "sp": 1}


def test_ring_fits_is_length_aware(monkeypatch):
    import tracs_tpu.parallel.allpairs as ap

    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    # without a word count: round-3 behavior (stripe budget only)
    assert ap.RingCoo.fits(64, mesh)
    # a genome long enough that resident operands alone exceed the device
    # budget refuses the ring — 2*5 planes * 32 rows * w * 4 B > budget
    monkeypatch.setenv("TRACS_TPU_DEVICE_HBM_BYTES", str(1 << 20))
    monkeypatch.setenv("TRACS_TPU_RING_BYTES", str(1 << 30))
    assert ap.RingCoo.fits(64, mesh)  # still no length: only stripes checked
    assert not ap.RingCoo.fits(64, mesh, n_words=10_000)
    # a short genome at the same budget is fine once chunk temps are small
    monkeypatch.setenv("TRACS_TPU_CHUNK_BYTES", str(1 << 16))
    assert ap.RingCoo.fits(64, mesh, n_words=64)


@requires_8dev
def test_operand_budget_falls_back_to_sweep(rng, monkeypatch):
    """Over the length-aware budget, pairsnp_stream must route to
    ShardedSweep with byte-identical output (the long-genome analogue of
    the stripe-budget fallback test)."""
    import tracs_tpu.parallel.allpairs as ap
    from tracs_tpu.ops.pairsnp import pairsnp

    chars = np.array(list("ACGTN"))
    seqs = ["".join(rng.choice(chars, size=400)) for _ in range(13)]
    base = pairsnp([pack_sequences(seqs)], dist=250, row_block=5)

    made_ring = []
    real_init = ap.RingCoo.__init__
    monkeypatch.setattr(
        ap.RingCoo, "__init__",
        lambda self, *a, **k: (made_ring.append(1), real_init(self, *a, **k))[1],
    )
    monkeypatch.setenv("TRACS_TPU_DEVICE_HBM_BYTES", "1")  # operands never fit
    over = pairsnp(
        [pack_sequences(seqs)], dist=250, row_block=5, mesh=make_mesh(4, 2)
    )
    assert not made_ring
    for x, y in zip(base, over):
        assert list(x) == list(y)


def test_peek_fasta_dims(tmp_path):
    from tracs_tpu.stages.distance import _peek_fasta_dims

    plain = tmp_path / "a.fasta"
    plain.write_text(">s0\n" + "ACGT" * 25 + "\n>s1\n" + "ACGT" * 25 + "\n")
    assert _peek_fasta_dims(str(plain)) == (2, (100 + 31) // 32)

    gz = tmp_path / "b.fasta.gz"
    with gzip.open(gz, "wt") as fh:
        for i in range(37):
            fh.write(f">s{i}\n" + "A" * 65 + "\n")
    assert _peek_fasta_dims(str(gz)) == (37, 3)

    # single record; multi-line sequence
    one = tmp_path / "c.fasta"
    one.write_text(">only\nACGT\nACGTAC\n")
    assert _peek_fasta_dims(str(one)) == (1, 1)

    assert _peek_fasta_dims(str(tmp_path / "missing.fasta")) == (None, None)


@requires_8dev
def test_distance_stage_auto_mesh_byte_identical(tmp_path, rng):
    """End-to-end: the distance CLI on --mesh auto (dims-aware shape) emits
    the same CSV bytes as --mesh off."""
    import argparse

    from tracs_tpu.stages.distance import distance_parser

    chars = np.array(list("ACGT"))
    base = rng.choice(chars, size=600)
    recs = []
    for i in range(12):
        s = base.copy()
        idx = rng.choice(600, size=8, replace=False)
        s[idx] = rng.choice(chars, size=8)
        recs.append((f"s{i}", "".join(s)))
    msa = tmp_path / "m.fasta"
    msa.write_text("".join(f">{n}\n{s}\n" for n, s in recs))

    outs = {}
    for spec in ("off", "auto"):
        out = tmp_path / f"d_{spec}.csv"
        parser = distance_parser(argparse.ArgumentParser())
        args = parser.parse_args([
            "--msa", str(msa), "-o", str(out), "-D", "50",
            "--row-block", "5", "--mesh", spec,
        ])
        args.func(args)
        outs[spec] = out.read_bytes()
    assert outs["off"] == outs["auto"]
