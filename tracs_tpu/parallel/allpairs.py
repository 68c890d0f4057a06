"""Sharded all-pairs SNP distances over a dp x sp device mesh.

Two production paths, both built on the two-gram split-decomposition kernel
(ops/pairsnp.py::_dense_split — the fast path measured 6x quicker than the
signed 5-channel matmul) with the same word-chunk HBM budgeting as the
single-device sweep:

1. **ShardedSweep** — the streaming engine behind ``tracs-tpu distance``
   on a mesh (the device-mesh replacement for the reference's OpenMP row
   loop, src/pairsnp.hpp:380-432).  DB samples are sharded over ``dp``
   (each device owns the *columns* of every block matrix for its sample
   shard) and packed words over ``sp``; each row block is replicated over
   dp, so a block sweep needs NO communication beyond the row-block
   broadcast and the final psum over sp — every D entry is computed by
   exactly one (dp) device with the single-device kernel, which is what
   makes the streamed CSV byte-identical to the one-chip run regardless of
   mesh shape.  Device-side thresholding/COO compaction then runs on the
   dp-sharded block (ops/pairsnp.py::_extract_coo_packed) so only survivors cross
   the host link.

2. **sharded_snp_distance** — dense [n, n] output via a triangle ring
   schedule: every device holds one resident sample block; a travelling
   copy rotates around the dp ring (``ppermute``) for ``n_dp//2 + 1``
   steps (half of the naive n_dp — symmetry: after computing block pair
   (r, r-s) each device returns the transposed block to rank r-s, one
   [B, B] int32 ppermute, ~1000x smaller than rotating the operands).
   Per-pair grams are commutative sums over positions, so the sp axis
   reduces with a single ``psum`` at the end.

Determinism: outputs are assembled by block origin index and every entry
is an exact int32 sum, so results are bit-identical to the single-device
kernel for any mesh shape (tests/test_sharded.py, forced 8-device CPU
mesh).  The recombination filter's windowed statistics are the only
non-commutative part of the pipeline and run in the dedicated filter pass
(ops/recomb.py) on host-gathered survivor bitsets, not here.

Multi-host: the same code over a mesh spanning processes
(jax.distributed.initialize via parallel/multihost.py); ``_put`` switches
to make_array_from_callback so each host materialises only its addressable
shards.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tracs_tpu.ops.packing import PackedAlignment, compact_variant_columns
from tracs_tpu.ops.pairsnp import (
    _assemble_d,
    _assemble_nn,
    _dense_split,
    _gram_partial,
    _split_pair,
    plan_chunks,
)
from tracs_tpu.parallel.mesh import make_mesh, pad_to, to_host
from tracs_tpu.runtime.memory import memory_budgets


def _put(arr: np.ndarray, sharding: NamedSharding):
    """Host numpy -> sharded device array.  Multi-host safe: with >1
    process, device_put cannot address remote shards, so each process
    materialises its own via make_array_from_callback (every host holds
    the full host-side alignment — they all read the same FASTA)."""
    if jax.process_count() > 1:
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )
    return jax.device_put(arr, sharding)


def _pad_rows_words(arr: np.ndarray, n_pad: int, w_pad: int) -> np.ndarray:
    """Zero-pad the sample axis to n_pad and the (last) word axis to w_pad."""
    shape = (n_pad, *arr.shape[1:-1], w_pad)
    out = np.zeros(shape, dtype=arr.dtype)
    out[: arr.shape[0], ..., : arr.shape[-1]] = arr
    return out


# ---------------------------------------------------------------------------
# production streaming path: replicated row block x dp-sharded DB columns
# ---------------------------------------------------------------------------


def _block_sweep_local(excl_r, nm_r, pt_r, excl_d, nm_d, pt_d, *, wc, n_chunks):
    """shard_map body: row block (replicated over dp, word-sharded over sp)
    against this device's DB sample shard.  Returns this shard's columns of
    the match-gram and N-gram, summed over position shards."""
    m, gn = _dense_split(excl_r, nm_r, excl_d, nm_d, wc=wc, n_chunks=n_chunks)
    m = m + _gram_partial(pt_r, pt_d)
    m = jax.lax.psum(m, "sp")
    gn = jax.lax.psum(gn, "sp")
    return m, gn


@partial(jax.jit, static_argnames=("wc", "n_chunks", "mesh"))
def _block_sweep(excl_r, nm_r, pt_r, excl_d, nm_d, pt_d, *, wc, n_chunks, mesh):
    fn = jax.shard_map(
        partial(_block_sweep_local, wc=wc, n_chunks=n_chunks),
        mesh=mesh,
        in_specs=(
            P(None, None, "sp"),
            P(None, "sp"),
            P(None, None, "sp"),
            P("dp", None, "sp"),
            P("dp", "sp"),
            P("dp", None, "sp"),
        ),
        out_specs=(P(None, "dp"), P(None, "dp")),
    )
    return fn(excl_r, nm_r, pt_r, excl_d, nm_d, pt_d)


class ShardedSweep:
    """Mesh-resident query-vs-db block sweep — the multi-chip engine behind
    ``pairsnp_stream(..., mesh=...)``.

    ``sa``/``sb`` are SplitAlignments sharing the partial-site gather axis
    (build with ops.pairsnp._split_pair).  The DB side is uploaded once and
    stays sharded P('dp', None, 'sp'); ``launch`` replicates one row block
    and returns device (D, NN) int32 blocks of shape [rb, n_pad] — columns
    beyond ``sb.n_seqs`` are mesh padding and must be masked by the caller
    (ops/pairsnp.py passes n_valid to the count/extract kernels).
    """

    def __init__(self, sa, sb, mesh: Mesh):
        if sa.length != sb.length:
            raise ValueError("alignments must share sequence length")
        self.mesh = mesh
        self.sa, self.sb = sa, sb
        self.n_dp = int(mesh.shape["dp"])
        self.n_sp = int(mesh.shape["sp"])
        n = sb.n_seqs
        self.n_pad = pad_to(max(n, 1), self.n_dp)
        W = sb.excl.shape[2]
        self.w_pad = pad_to(max(W, 1), 8 * self.n_sp)
        wp = max(sa.partial.shape[2], sb.partial.shape[2])
        self.wp_pad = pad_to(max(wp, 1), self.n_sp)

        db3 = NamedSharding(mesh, P("dp", None, "sp"))
        db2 = NamedSharding(mesh, P("dp", "sp"))
        self._db = (
            _put(_pad_rows_words(sb.excl, self.n_pad, self.w_pad), db3),
            _put(_pad_rows_words(sb.nmask, self.n_pad, self.w_pad), db2),
            _put(_pad_rows_words(sb.partial, self.n_pad, self.wp_pad), db3),
        )
        cnt = np.zeros(self.n_pad, np.int32)
        cnt[:n] = sb.cnt_n
        self._cnt_d = _put(cnt, NamedSharding(mesh, P()))
        self._row3 = NamedSharding(mesh, P(None, None, "sp"))
        self._row2 = NamedSharding(mesh, P(None, "sp"))
        self._rep = NamedSharding(mesh, P())

    def launch(self, r0: int, r1: int):
        """Enqueue the sweep of rows [r0, r1) against the whole DB shard set;
        returns device (D [rb, n_pad], NN [rb, n_pad]) without waiting."""
        sa = self.sa
        rb = r1 - r0
        ex = _put(_pad_rows_words(sa.excl[r0:r1], rb, self.w_pad), self._row3)
        nm = _put(_pad_rows_words(sa.nmask[r0:r1], rb, self.w_pad), self._row2)
        pt = _put(_pad_rows_words(sa.partial[r0:r1], rb, self.wp_pad), self._row3)
        cnt_r = _put(sa.cnt_n[r0:r1].astype(np.int32), self._rep)
        # HBM budget rows per device: the replicated row block + this dp
        # rank's DB shard, 5 channels each (4 exclusive + N mask)
        rows = rb + self.n_pad // self.n_dp
        wc, n_chunks = plan_chunks(rows, 5, self.w_pad // self.n_sp)
        m, gn = _block_sweep(
            ex, nm, pt, *self._db, wc=wc, n_chunks=n_chunks, mesh=self.mesh
        )
        L32 = jnp.int32(sa.length)
        gp0 = jnp.zeros((), jnp.int32)  # partial gram already folded into m
        D = _assemble_d(m, gp0, cnt_r, self._cnt_d, L32)
        NN = _assemble_nn(gn, cnt_r, self._cnt_d, L32)
        return D, NN


# ---------------------------------------------------------------------------
# streaming triangle ring: work-efficient mesh self-all-pairs with on-device
# COO extraction (the mesh analogue of the single-device prefix schedule)
# ---------------------------------------------------------------------------


def _ring_coo_local(excl, nmask, part, cnt_blk, cnt_all, *, n_dp, wc, n_chunks,
                    L, dist, n_valid, capacity, B):
    """shard_map body: triangle-ring grams for this device's resident row
    stripe, assembled to (D, NN) and COO-compacted on device.  Returns
    (D [B, n_pad], NN [B, n_pad], packed [1, 1+3*capacity]) — D/NN stay
    device-resident for the rare overflow/dense-stripe fallbacks; only the
    packed survivors need cross the host link."""
    from tracs_tpu.ops.pairsnp import _extract_coo_packed

    m_rows, n_rows = _ring_allpairs_local(
        excl, nmask, part, n_dp=n_dp, wc=wc, n_chunks=n_chunks
    )
    my = jax.lax.axis_index("dp")
    r0 = (my * B).astype(jnp.int32)
    L32 = jnp.int32(L)
    D = (L32 - (m_rows + cnt_blk[:, None] + cnt_all[None, :])).astype(jnp.int32)
    NN = (L32 - cnt_blk[:, None] - cnt_all[None, :] + n_rows).astype(jnp.int32)
    packed = _extract_coo_packed(
        D, NN, jnp.int32(dist), r0, jnp.int32(n_valid), jnp.int32(0),
        capacity=capacity, triangle=True, with_nn=True,
    )
    return D, NN, packed[None, :]


@partial(jax.jit, static_argnames=(
    "n_dp", "wc", "n_chunks", "L", "dist", "n_valid", "capacity", "B", "mesh"))
def _ring_coo(excl, nmask, part, cnt_blk, cnt_all, *, n_dp, wc, n_chunks, L,
              dist, n_valid, capacity, B, mesh):
    fn = jax.shard_map(
        partial(_ring_coo_local, n_dp=n_dp, wc=wc, n_chunks=n_chunks, L=L,
                dist=dist, n_valid=n_valid, capacity=capacity, B=B),
        mesh=mesh,
        in_specs=(P("dp", None, "sp"), P("dp", "sp"), P("dp", None, "sp"),
                  P("dp"), P()),
        out_specs=(P("dp", None), P("dp", None), P("dp", None)),
    )
    return fn(excl, nmask, part, cnt_blk, cnt_all)


class RingCoo:
    """Work-efficient mesh engine for streamed SELF all-pairs: each device
    holds one resident row stripe, the triangle ring meets every block pair
    once (n_dp//2 + 1 rotations — half the MACs of sweeping every row block
    against the full dp-sharded DB), and thresholding + COO compaction run
    per stripe on its owning device.  One host transfer fetches every
    stripe's packed survivors; emission order (row-major, j > i) and all
    values are identical to the single-device run.

    Used by pairsnp_stream(mesh=...) for triangle runs from row 0 whose
    stripe tensors fit the HBM budget (``fits``); the per-block
    ShardedSweep remains for 2-fasta rectangles, mid-matrix resume and
    over-budget runs.  NOTE the whole matrix is ONE jit dispatch: device
    HBM holds [B, n_pad] int32 stripes per device regardless of
    --row-block, and an interrupt during the dispatch loses the entire
    sweep (the cursor only advances once stripes start yielding) —
    that is the price of the halved MACs + single transfer.  Matches
    reference src/pairsnp.hpp:380-432 (OpenMP row loop).
    """

    @staticmethod
    def stripe_bytes(n: int, mesh: Mesh) -> int:
        """Peak per-device bytes of the stripe tensors: m/n gram rows plus
        the assembled D/NN, all [B, n_pad] int32 (4 arrays)."""
        n_dp = int(mesh.shape["dp"])
        B = pad_to(max(n, 1), n_dp) // n_dp
        return 4 * B * (B * n_dp) * 4

    @staticmethod
    def operand_bytes(n: int, mesh: Mesh, n_words: int) -> int:
        """Per-device bytes of the packed operands the ring keeps resident:
        the device's own stripe plus the travelling copy, 5 word-planes
        each (4 exclusive + N mask), sharded over sp."""
        n_dp = int(mesh.shape["dp"])
        n_sp = int(mesh.shape["sp"])
        B = pad_to(max(n, 1), n_dp) // n_dp
        w_shard = pad_to(max(n_words, 1), 8 * n_sp) // n_sp
        return 2 * 5 * B * w_shard * 4

    @classmethod
    def fits(cls, n: int, mesh: Mesh, n_words: int | None = None) -> bool:
        """Whether a ring dispatch at this (n, mesh[, genome length]) stays
        inside the HBM budgets.  Without ``n_words`` only the stripe-output
        budget is checked (the round-3 behavior); with it the resident
        operands and the gram chunk-temp budget are accounted too, so a
        long-genome run falls back to the block-streamed ShardedSweep
        instead of dispatching a ring destined to OOM mid-sweep."""
        budgets = memory_budgets()
        stripes = cls.stripe_bytes(n, mesh)
        if stripes > budgets.ring_stripe:
            return False
        if n_words is not None:
            total = stripes + cls.operand_bytes(n, mesh, n_words) + budgets.chunk
            if total > budgets.device:
                return False
        return True

    def __init__(self, sa, mesh: Mesh, dist: int, capacity: int | None = None,
                 density_hint: float | None = None):
        self.sa = sa
        self.mesh = mesh
        self.dist = int(dist)
        n_dp = int(mesh.shape["dp"])
        n_sp = int(mesh.shape["sp"])
        n = sa.n_seqs
        self.n = n
        self.B = pad_to(max(n, 1), n_dp) // n_dp
        n_pad = self.B * n_dp
        self.n_pad = n_pad
        W = sa.excl.shape[2]
        w_pad = pad_to(max(W, 1), 8 * n_sp)
        wp_pad = pad_to(max(sa.partial.shape[2], 1), n_sp)

        excl = _pad_rows_words(sa.excl, n_pad, w_pad)
        nmask = _pad_rows_words(sa.nmask, n_pad, w_pad)
        part = _pad_rows_words(sa.partial, n_pad, wp_pad)
        cnt = np.zeros(n_pad, np.int32)
        cnt[:n] = sa.cnt_n

        self._ex = _put(excl, NamedSharding(mesh, P("dp", None, "sp")))
        self._nm = _put(nmask, NamedSharding(mesh, P("dp", "sp")))
        self._pt = _put(part, NamedSharding(mesh, P("dp", None, "sp")))
        self._cnt_blk = _put(cnt, NamedSharding(mesh, P("dp")))
        self._cnt_all = _put(cnt, NamedSharding(mesh, P()))
        self._wc, self._n_chunks = plan_chunks(2 * self.B, 5, w_pad // n_sp)
        if capacity is None:
            capacity = self.plan_capacity(self.B, n_pad, density_hint)
        # power-of-two capacity bounds recompiles across runs
        cap = 1 << max(12, int(np.ceil(np.log2(max(2, capacity)))))
        self.capacity = min(cap, self.B * n_pad)

    @staticmethod
    def plan_capacity(B: int, n_pad: int, density_hint: float | None) -> int:
        """Per-stripe speculative extraction capacity (pre power-of-two
        bucketing).  With a measured survivor density from a previous
        MSA/run, size to 2x that rate so realistic survivor distributions
        stop tripping the full-capacity re-extraction fallback; otherwise
        the blind default covers ~1/64 density, floored so the
        always-transferred packed array stays one small transfer."""
        if density_hint is not None and density_hint > 0:
            return max(1 << 14, int(2 * density_hint * B * n_pad) + 1)
        return max(1 << 14, (B * n_pad) // 64)

    def stripes(self):
        """Yield (r0, r1, rows_local, cols, dvals, nvals) per dp stripe in
        ascending row order — the same per-block contract as the
        single-device streaming loop."""
        from tracs_tpu.ops.pairsnp import (
            _host_block_sparse,
            _stream_block_sparse,
            _unpack_survivors,
        )

        D_all, NN_all, packed_dev = _ring_coo(
            self._ex, self._nm, self._pt, self._cnt_blk, self._cnt_all,
            n_dp=int(self.mesh.shape["dp"]), wc=self._wc,
            n_chunks=self._n_chunks, L=self.sa.length, dist=self.dist,
            n_valid=self.n, capacity=self.capacity, B=self.B, mesh=self.mesh,
        )
        packed_h = to_host(packed_dev)  # ONE transfer for all stripes
        D_h = NN_h = None
        for d in range(int(self.mesh.shape["dp"])):
            r0 = d * self.B
            if r0 >= self.n:
                break
            r1 = min(self.n, r0 + self.B)
            count = int(packed_h[d, 0])
            stripe_elems = (r1 - r0) * (self.n - r0)
            if count <= self.capacity and 2 * count <= max(stripe_elems, 2):
                rows_l, cols, dvals, nvals = _unpack_survivors(
                    packed_h[d], self.capacity, count, self.n_pad
                )
            else:
                # capacity overflow (default capacity covers ~1/64 survivor
                # density; nothing adapts within a run — the whole matrix is
                # one dispatch) or a dense stripe: extract from the
                # device-resident stripe, or — multi-process, where slicing
                # a cross-process stripe eagerly is not addressable — from
                # a one-time host gather of the dense matrices
                if D_all.is_fully_addressable:
                    rows_l, cols, dvals, nvals = _stream_block_sparse(
                        D_all[r0 : r0 + self.B], NN_all[r0 : r0 + self.B],
                        self.dist, r0, self.n, count, triangle=True,
                    )
                else:
                    if D_h is None:
                        D_h, NN_h = to_host(D_all), to_host(NN_all)
                    rows_l, cols, dvals, nvals = _host_block_sparse(
                        D_h[r0 : r0 + self.B], NN_h[r0 : r0 + self.B],
                        self.dist, r0, self.n, triangle=True,
                    )
            yield r0, r1, rows_l, cols, dvals, nvals


def _ring_allpairs_local(excl, nmask, part, *, n_dp: int, wc: int, n_chunks: int):
    """shard_map body: per-(dp, sp) shard tensors
    excl [B, 4, Ws], nmask [B, Ws], part [B, 4, Wp].
    Returns (match-gram rows [B, n_dp*B], N-gram rows), psum'd over sp.

    Triangle schedule: step s computes block pair (my, my-s).  Each
    unordered pair of blocks meets once in n_dp//2 + 1 steps; the
    transposed result is returned to the partner rank (a [B, B] int32
    ppermute — tiny next to rotating the packed operands), halving both
    ring rotations and gram work vs the naive every-ordered-pair sweep.
    Step 0 is the self block and uses _dense_split's unpack-once
    ``same=True`` fast path.
    """
    B = excl.shape[0]
    my = jax.lax.axis_index("dp")
    m_rows = jnp.zeros((B, n_dp * B), jnp.int32)
    n_rows = jnp.zeros((B, n_dp * B), jnp.int32)
    half = n_dp // 2
    trav = (excl, nmask, part)
    zero = jnp.int32(0)
    for step in range(half + 1):
        t_excl, t_nmask, t_part = trav
        m, gn = _dense_split(
            excl, nmask, t_excl, t_nmask,
            wc=wc, n_chunks=n_chunks, same=(step == 0),
        )
        m = m + _gram_partial(part, t_part)
        origin = ((my - step) % n_dp).astype(jnp.int32)
        m_rows = jax.lax.dynamic_update_slice(m_rows, m, (zero, origin * B))
        n_rows = jax.lax.dynamic_update_slice(n_rows, gn, (zero, origin * B))
        # mirror the block to its transpose position: pair (my, my-s)
        # computed here is pair (my-s, my) on rank my-s.  For even n_dp the
        # final step's partner column coincides with the own store
        # ((my-half) == (my+half) mod n_dp), so the mirror is skipped.
        if step > 0 and (n_dp % 2 == 1 or step < half):
            perm_back = [(r, (r - step) % n_dp) for r in range(n_dp)]
            m_t = jax.lax.ppermute(m.T, "dp", perm_back)
            gn_t = jax.lax.ppermute(gn.T, "dp", perm_back)
            src = ((my + step) % n_dp).astype(jnp.int32)
            m_rows = jax.lax.dynamic_update_slice(m_rows, m_t, (zero, src * B))
            n_rows = jax.lax.dynamic_update_slice(n_rows, gn_t, (zero, src * B))
        if step < half:
            # rotate the travelling block one rank forward around the ring
            perm = [(r, (r + 1) % n_dp) for r in range(n_dp)]
            trav = tuple(jax.lax.ppermute(t, "dp", perm) for t in trav)

    # position shards hold partial grams: commutative sum -> one psum
    m_rows = jax.lax.psum(m_rows, "sp")
    n_rows = jax.lax.psum(n_rows, "sp")
    return m_rows, n_rows


@partial(jax.jit, static_argnames=("n_dp", "wc", "n_chunks", "mesh"))
def _ring_allpairs(excl, nmask, part, *, n_dp: int, wc: int, n_chunks: int, mesh: Mesh):
    fn = jax.shard_map(
        partial(_ring_allpairs_local, n_dp=n_dp, wc=wc, n_chunks=n_chunks),
        mesh=mesh,
        in_specs=(P("dp", None, "sp"), P("dp", "sp"), P("dp", None, "sp")),
        out_specs=(P("dp", None), P("dp", None)),
    )
    return fn(excl, nmask, part)


def sharded_snp_distance(
    packed: PackedAlignment,
    mesh: Mesh | None = None,
    *,
    compact: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (D, NN) int32 matrices computed over a dp x sp device mesh
    with the split-decomposition kernel.  Matches ``snp_distance_dense``
    bit-for-bit; use for sample counts / genome lengths that exceed a
    single device.  (For threshold/COO streaming use
    ``pairsnp_stream(..., mesh=...)`` — this returns the full dense matrix.)

    ``compact`` (default on; ``TRACS_TPU_COMPACT=0`` disables) applies
    variant-site compaction before sharding — the distance matrix is exactly
    unchanged and NN shifts by a scalar (ops/packing.py), while the sharded
    position axis and ring traffic shrink by the conserved fraction."""
    if mesh is None:
        mesh = make_mesh(len(jax.devices()), 1)
    n_dp = int(mesh.shape["dp"])
    n_sp = int(mesh.shape["sp"])

    if compact is None:
        compact = os.environ.get("TRACS_TPU_COMPACT", "1") != "0"
    nn_off = 0
    if compact:
        comp = compact_variant_columns(packed)
        if comp is not None:
            packed = comp[0]
            nn_off = comp[3]

    sa, _ = _split_pair(packed, None)
    n = sa.n_seqs
    W = sa.excl.shape[2]
    Wp = sa.partial.shape[2]
    L = sa.length
    B = pad_to(max(n, 1), n_dp) // n_dp
    w_pad = pad_to(max(W, 1), 8 * n_sp)
    wp_pad = pad_to(max(Wp, 1), n_sp)

    excl = _pad_rows_words(sa.excl, n_dp * B, w_pad)
    nmask = _pad_rows_words(sa.nmask, n_dp * B, w_pad)
    part = _pad_rows_words(sa.partial, n_dp * B, wp_pad)

    ex_dev = _put(excl, NamedSharding(mesh, P("dp", None, "sp")))
    nm_dev = _put(nmask, NamedSharding(mesh, P("dp", "sp")))
    pt_dev = _put(part, NamedSharding(mesh, P("dp", None, "sp")))

    # HBM budget rows: resident + travelling block, 5 channels each
    wc, n_chunks = plan_chunks(2 * B, 5, w_pad // n_sp)
    m, gn = _ring_allpairs(
        ex_dev, nm_dev, pt_dev, n_dp=n_dp, wc=wc, n_chunks=n_chunks, mesh=mesh
    )
    m = to_host(m)[:n, :n]
    gn = to_host(gn)[:n, :n]

    cnt = sa.cnt_n[:, None] + sa.cnt_n[None, :]
    D = (L - (m + cnt)).astype(np.int32)
    NN = (L - cnt + gn + nn_off).astype(np.int32)
    return D, NN
