"""Empirical-Bayes Dirichlet-multinomial model.

* ``find_dirichlet_priors`` — fit the 4-dim (generally K-dim) Dirichlet-
  multinomial concentration vector by Minka fixed-point iteration (FPI) or
  leave-one-out (LOO), with the reference's exchangeability trick of sorting
  each count row (reference tracs/dirichlet_multinomial.py:9-73; golden-tested
  against R MGLM::MGLMfit, reference tests/test_dirichlet_multinomial.py).

* ``calculate_posteriors`` — rank-tied posterior allele frequencies
  (reference src/dmultinomial.hpp:8-86): counts argsorted descending per row;
  the r-th *distinct* count value gets the r-th largest alpha; ties share a
  rank; zero-coverage rows get alpha_max/alpha0 everywhere; posteriors <=
  threshold are zeroed, or clamped up to the threshold when ``keep`` and the
  raw count is positive.

Design notes: the fit is a fixed-shape ``lax.while_loop`` over rows padded
to a power-of-two bucket (zero rows contribute exactly 0 to every digamma /
ratio sum, so padding is free), in float64 on the CPU backend (the golden
tolerances need f64; this is a once-per-reference-genome fit, not a hot
kernel).  The posterior kernel is fully vectorised — the reference's
per-row C++ loop with a stable sort becomes a batched distinct-rank
computation on [R, K] tensors.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

def _cpu():
    """The f64 host backend device — resolved lazily so importing the
    package never initialises XLA backends (jax.distributed.initialize
    must run first in multi-process programs), and LOCAL so the pinned
    jits stay process-local under a multi-process runtime
    (jax.devices()[0] would be another process's device on rank > 0)."""
    return jax.local_devices(backend="cpu")[0]


# ---------------------------------------------------------------------------
# prior fitting
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("method", "max_iter"))
def _fit_loop(data, alpha0, tol, *, method: str, max_iter: int):
    """data [R, K] float64 row-sorted counts (zero-padded rows allowed)."""
    psi = jax.scipy.special.digamma
    total = jnp.sum(data, axis=1)

    def fpi_step(alpha):
        a0 = jnp.sum(alpha)
        num = jnp.sum(psi(data + alpha[None, :]) - psi(alpha)[None, :], axis=0)
        den = jnp.sum(psi(total + a0) - psi(a0), axis=0)
        return alpha * num / den

    def loo_step(alpha):
        a0 = jnp.sum(alpha)
        num = jnp.sum(data / (data - 1.0 + alpha[None, :]), axis=0)
        den = jnp.sum(total / (total - 1.0 + a0), axis=0)
        return alpha * num / den

    step = fpi_step if method == "FPI" else loo_step

    def cond(state):
        alpha, it, done = state
        return jnp.logical_not(done) & (it < max_iter)

    def body(state):
        alpha, it, _ = state
        nalpha = step(alpha)
        if method == "FPI":
            converged = jnp.sum(jnp.abs(nalpha - alpha)) < tol
            # clamp applied only when continuing (reference
            # dirichlet_multinomial.py:64-68: break happens before the clamp)
            out = jnp.where(converged, nalpha, jnp.maximum(nalpha, 1e-16))
        else:
            converged = jnp.max(jnp.abs(nalpha - alpha)) < tol
            out = nalpha
        return out, it + 1, converged

    alpha, _, _ = jax.lax.while_loop(cond, body, (alpha0, 0, False))
    return alpha


def find_dirichlet_priors(counts, max_iter=1000, tol=1e-5, method="FPI", error_filt_threshold=None):
    """Fit Dirichlet-multinomial alphas; mirrors the reference function
    including its quirks: any method string other than "LOO" selects FPI
    (the golden test passes 'FP'), and fewer than 6 polymorphic rows returns
    the fixed 4-vector [0, 0, 0, 1.0] regardless of K
    (dirichlet_multinomial.py:26-29)."""
    data = np.array(counts, dtype=np.float64)

    if error_filt_threshold is not None:
        rs = np.sum(data, axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            freq = np.where(rs[:, None] > 0, data / np.where(rs[:, None] > 0, rs[:, None], 1.0), np.nan)
        data[np.nan_to_num(freq, nan=np.inf) < error_filt_threshold] = 0

    nz = np.count_nonzero(data, axis=1)
    if not (np.sum(nz > 1) > 5):
        return np.array([0, 0, 0, 1.0])

    data = data[nz > 1]
    data.sort(axis=1)

    alpha0 = np.mean(data, axis=0) + 0.5

    # pad rows to a power-of-two bucket: zero rows contribute 0 to both FPI
    # digamma sums and LOO ratio sums, so results are unchanged
    rows = data.shape[0]
    bucket = 1 << max(4, math.ceil(math.log2(rows)))
    if bucket > rows:
        data = np.pad(data, ((0, bucket - rows), (0, 0)))

    meth = "LOO" if method == "LOO" else "FPI"
    with jax.default_device(_cpu()):
        alpha = _fit_loop(
            jnp.asarray(data), jnp.asarray(alpha0), jnp.float64(tol),
            method=meth, max_iter=max_iter,
        )
    alpha = np.asarray(alpha).copy()
    alpha[::-1].sort()
    return alpha


# ---------------------------------------------------------------------------
# posterior allele frequencies
# ---------------------------------------------------------------------------

@jax.jit
def _posteriors_kernel(counts, alphas, keep, expected):
    """counts [R, K] f64, alphas [K] f64 sorted desc."""
    a0 = jnp.sum(alphas)
    a_min = alphas[0] / a0
    denom = jnp.sum(counts, axis=1, keepdims=True)

    # distinct rank: for element j, the number of *distinct* values in its row
    # strictly greater than counts[j] — exactly the reference's alpha_index
    # walk over a stable descending argsort (dmultinomial.hpp:44-66)
    s = -jnp.sort(-counts, axis=1)  # descending values [R, K]
    is_new = jnp.concatenate(
        [jnp.zeros((counts.shape[0], 1), bool), s[:, 1:] < s[:, :-1]], axis=1
    )
    # rank of the m-th sorted value = cumsum of boundaries
    # element rank = sum over m of is_new[m] where s[m] > value
    gt = s[:, :, None] > counts[:, None, :]  # [R, K(sorted m), K(elem j)]
    # is_new[0] is False, so the largest value's distinct slot is counted by
    # the any() term (s[0] > v iff any value > v, s being sorted descending)
    rank = jnp.sum(gt & is_new[:, :, None], axis=1) + jnp.any(gt, axis=1).astype(jnp.int32)

    post = (counts + alphas[rank]) / (denom + a0)
    post = jnp.where(denom <= 0, a_min, post)

    below = post <= expected
    clamp = keep & (counts > 0)
    post = jnp.where(below, jnp.where(clamp, expected, 0.0), post)
    return post


def calculate_posteriors(counts, alphas, keep, expected):
    """Reference-compatible wrapper (C++ ``calculate_posteriors``,
    src/dmultinomial.hpp:8-86).  counts [R, K]; alphas length K (sorted
    descending internally); returns float64 [R, K]."""
    counts = np.asarray(counts, dtype=np.float64)
    alphas = np.sort(np.asarray(alphas, dtype=np.float64))[::-1].copy()
    with jax.default_device(_cpu()):
        out = _posteriors_kernel(
            jnp.asarray(counts), jnp.asarray(alphas), bool(keep), float(expected)
        )
    return np.array(out)  # writable copy (callers mutate, align.py:599-613)
