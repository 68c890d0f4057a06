"""Checks that mean something only on a GPU.

Each function runs on JAX's default device and raises AssertionError on a
mismatch.  ``tests/test_gpu.py`` runs them as ``gpu``-marked tests, which
skip on the CPU (the test conftest pins the CPU), and ``chip_smoke.py``
calls them directly on the card (its phase 4).  Shapes are small: these
check lowering and exactness, not speed.
"""

from __future__ import annotations

import numpy as np


def _random_alignment(n: int, L: int, seed: int):
    """Random IUPAC alignment with every code, N and gaps included."""
    from tracs_tpu.ops.packing import pack_sequences

    rng = np.random.default_rng(seed)
    chars = np.array(list("ACGTMRWSYKVHDBN-"))
    weights = np.array([0.2] * 4 + [0.01] * 10 + [0.06, 0.04])
    seqs = ["".join(rng.choice(chars, size=L, p=weights / weights.sum()))
            for _ in range(n)]
    return pack_sequences(seqs)


def check_gram_dots_lower_to_gemm():
    """Every dot of the production gram (``_dense_split_ranged``) becomes a
    cuBLAS GEMM call or a Triton GEMM fusion with s8 operands."""
    import jax
    import jax.numpy as jnp

    from bench import dot_lowerings, is_s8_gemm
    from tracs_tpu.ops.pairsnp import _dense_split_ranged

    n, W, rb = 512, 1024, 256
    compiled = _dense_split_ranged.lower(
        jax.ShapeDtypeStruct((n, 4, W), jnp.uint32),
        jax.ShapeDtypeStruct((n, W), jnp.uint32),
        jax.ShapeDtypeStruct((), jnp.int32),
        rb=rb, c0=0, wc=512, n_chunks=2,
    ).compile()
    dots = dot_lowerings(compiled.as_text())
    assert dots, "no matrix product found in the optimized HLO"
    for d in dots:
        assert is_s8_gemm(d), d


def check_prefix_blocks_match_oracle():
    """The prefix-triangle split grams equal the numpy oracle exactly,
    partial-IUPAC correction included."""
    from bench import reference_rows
    from tracs_tpu.ops.pairsnp import _split_pair, snp_distance_split_prefix_device

    packed = _random_alignment(40, 3001, seed=1)
    sa, _ = _split_pair(packed, None)
    n = packed.n_seqs
    for r0, r1 in ((0, 16), (16, 32), (32, 40)):
        D, NN, c0 = snp_distance_split_prefix_device(sa, r0, r1)
        D_ref, NN_ref = reference_rows(packed.planes, range(r0, r1), packed.length)
        assert np.array_equal(np.asarray(D), D_ref[:, c0:n])
        assert np.array_equal(np.asarray(NN), NN_ref[:, c0:n])


def check_coo_extraction_matches_numpy():
    """Device COO compaction (hierarchical cumsum + searchsorted) emits
    the numpy nonzero of the thresholded triangle, in row-major order."""
    import jax.numpy as jnp

    from tracs_tpu.ops.pairsnp import _extract_coo_packed, _unpack_survivors

    rng = np.random.default_rng(2)
    D = rng.integers(0, 100, size=(64, 300)).astype(np.int32)
    NN = rng.integers(0, 1000, size=(64, 300)).astype(np.int32)
    r0, c0, dist = 40, 20, 30
    packed = np.asarray(_extract_coo_packed(
        jnp.asarray(D), jnp.asarray(NN), dist, jnp.int32(r0), jnp.int32(290),
        jnp.int32(c0), capacity=8192, triangle=True,
    ))
    count = int(packed[0])
    rows, cols, dvals, nvals = _unpack_survivors(packed, 8192, count, 300, c0)
    gcols = np.arange(300) + c0
    mask = (D <= dist) & (gcols[None, :] < 290) & (gcols[None, :] > np.arange(64)[:, None] + r0)
    want_r, want_c = np.nonzero(mask)
    assert np.array_equal(rows, want_r) and np.array_equal(cols, want_c + c0)
    assert np.array_equal(dvals, D[mask]) and np.array_equal(nvals, NN[mask])


def check_mismatch_positions_match_host():
    """Device mismatch-position extraction (the --filter input) equals the
    host bitset scan."""
    from tracs_tpu.ops.pairsnp import mismatch_positions_device, mismatch_words

    packed = _random_alignment(12, 9000, seed=3)
    ii = np.array([0, 1, 2, 5, 7, 10])
    jj = np.array([3, 4, 8, 6, 11, 11])
    words = mismatch_words(packed, packed, ii, jj)
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    cap = int(bits.sum(axis=1).max())
    counts, pos = mismatch_positions_device(packed, packed, ii, jj, cap)
    for k in range(len(ii)):
        want = np.nonzero(bits[k])[0]
        assert counts[k] == len(want)
        assert np.array_equal(pos[k, : len(want)], want)


def check_memory_budgets_follow_device():
    """The byte budgets are shares of the card's allocator limit."""
    from tracs_tpu.runtime.memory import (
        CPU_BUDGETS, device_bytes_limit, memory_budgets,
    )

    limit = device_bytes_limit()
    assert limit and limit > 0
    assert memory_budgets().chunk == CPU_BUDGETS.chunk * limit // (16 << 30)


CHECKS = [
    check_gram_dots_lower_to_gemm,
    check_prefix_blocks_match_oracle,
    check_coo_extraction_matches_numpy,
    check_mismatch_positions_match_host,
    check_memory_budgets_follow_device,
]
