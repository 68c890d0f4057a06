"""Drop-in compatibility layer for the reference's ``TRACS`` pybind11 module.

The reference exposes exactly four native functions
(reference src/python_bindings.cpp:8-26):

    from TRACS import pairsnp, lprob_k_given_N, trans_dist, calculate_posteriors

Code written against that interface works unchanged against this module:

    import tracs_tpu.compat as TRACS

Signatures, argument names, return structures and numerical semantics match;
the implementations are this package's device kernels.
"""

from __future__ import annotations

import numpy as np

from tracs_tpu.models.dirichlet import calculate_posteriors as _calculate_posteriors
from tracs_tpu.models.transcluster import lprob_k_given_N as _lprob_k_given_N
from tracs_tpu.models.transcluster import trans_dist as _trans_dist
from tracs_tpu.ops.pairsnp import pairsnp as _pairsnp


def pairsnp(fasta, n_threads=1, dist=2**31 - 1, filter=False):
    """(rows, cols, distances, seq_names, filt_distances, n_compared_sites)
    as Python lists — the reference binding's return convention."""
    return _pairsnp(fasta, n_threads=n_threads, dist=dist, filter=filter)


def lprob_k_given_N(N, k, delta, lamb, beta, lgamma):
    """(lprob, lhs) tuple (reference transcluster.hpp:90-129 variant)."""
    return _lprob_k_given_N(N, k, delta, lamb, beta, lgamma)


def trans_dist(snpdiff, datediff, lamb, beta, threshold_Ek=1e-6):
    """(p0, eK) as lists; p0 is log-space like the reference."""
    p0, eK = _trans_dist(snpdiff, datediff, lamb, beta, threshold_Ek)
    return list(p0), list(eK)


def calculate_posteriors(counts, alphas, keep, expected):
    """float64 [R, K] posterior matrix."""
    return _calculate_posteriors(np.asarray(counts), alphas, keep, expected)
