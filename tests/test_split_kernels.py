"""The production gram kernels, ``_dense_split_ranged`` and
``_accum_split_ranged``, against the numpy AND/OR/popcount oracle
(bench.reference_rows): several word chunks, a narrower tail chunk, an odd
genome length, and partial-IUPAC sites through the correction gram."""

import jax.numpy as jnp
import numpy as np
import pytest

from bench import reference_rows
from tracs_tpu.ops.packing import pack_sequences, split_alignment
from tracs_tpu.ops.pairsnp import (
    _accum_split_ranged,
    _assemble_d,
    _assemble_nn,
    _dense_split_ranged,
    _gram_partial,
)

# (case, n, rows [r0, r0 + rb), first column c0, alphabet)
CASES = [
    ("square", 24, 0, 24, 0, "ACGTN-"),
    ("rectangle", 40, 16, 8, 8, "ACGTN"),
    ("partial", 33, 8, 16, 4, "ACGTMRWSYKVHDBN-"),
]
L = 32 * 40 + 7  # 41 words: 4 chunks of 11 words, the last only 8 wide
WC = 11


def _layout(n, alphabet, seed):
    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    packed = pack_sequences(["".join(rng.choice(chars, size=L)) for _ in range(n)])
    sa = split_alignment(packed)
    return packed, sa, jnp.asarray(sa.excl), jnp.asarray(sa.nmask)


def _assemble(sa, m, gn, r0, rb, c0):
    pt = jnp.asarray(sa.partial)
    gp = (
        _gram_partial(pt[r0 : r0 + rb], pt[c0:])
        if sa.n_partial else jnp.zeros((), jnp.int32)
    )
    cnt = jnp.asarray(sa.cnt_n.astype(np.int32))
    L32 = jnp.int32(L)
    D = _assemble_d(m, gp, cnt[r0 : r0 + rb], cnt[c0:], L32)
    NN = _assemble_nn(gn, cnt[r0 : r0 + rb], cnt[c0:], L32)
    return np.asarray(D), np.asarray(NN)


@pytest.mark.parametrize("case,n,r0,rb,c0,alphabet", CASES, ids=[c[0] for c in CASES])
def test_dense_split_ranged_matches_oracle(case, n, r0, rb, c0, alphabet):
    packed, sa, ea, nm = _layout(n, alphabet, seed=len(case))
    W = ea.shape[2]
    m, gn = _dense_split_ranged(
        ea, nm, jnp.int32(r0), rb=rb, c0=c0, wc=WC, n_chunks=-(-W // WC)
    )
    D, NN = _assemble(sa, m, gn, r0, rb, c0)
    D_ref, NN_ref = reference_rows(packed.planes, range(r0, r0 + rb), L)
    assert np.array_equal(D, D_ref[:, c0:])
    assert np.array_equal(NN, NN_ref[:, c0:])
    if case == "partial":
        assert sa.n_partial > 0


@pytest.mark.parametrize("case,n,r0,rb,c0,alphabet", CASES, ids=[c[0] for c in CASES])
def test_accum_split_ranged_matches_oracle(case, n, r0, rb, c0, alphabet):
    """Chunk-major accumulation over upload chunks of 16 words (the last
    one 9 wide) gives the same grams as the one-shot kernel."""
    packed, sa, ea, nm = _layout(n, alphabet, seed=len(case))
    W = ea.shape[2]
    acc = jnp.zeros((rb, n - c0), jnp.int32)
    accn = jnp.zeros((rb, n - c0), jnp.int32)
    for w0 in range(0, W, 16):
        cw = min(16, W - w0)
        acc, accn = _accum_split_ranged(
            ea, nm, acc, accn, jnp.int32(r0), jnp.int32(w0),
            rb=rb, c0=c0, chunk_w=cw, wc=5, n_chunks=-(-cw // 5),
        )
    D, NN = _assemble(sa, acc, accn, r0, rb, c0)
    D_ref, NN_ref = reference_rows(packed.planes, range(r0, r0 + rb), L)
    assert np.array_equal(D, D_ref[:, c0:])
    assert np.array_equal(NN, NN_ref[:, c0:])
