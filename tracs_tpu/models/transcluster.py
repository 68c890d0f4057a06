"""TransCluster model: P(k intermediate hosts | N SNPs, time gap delta).

Implements the Stimson et al. 2019 transmission model with the exact
semantics of the reference C++ kernel (reference src/transcluster.hpp):

* ``lprob_k_given_N``      — public API, the reference's first variant
                             (transcluster.hpp:90-129), golden-tested against
                             a Sage integral (reference tests/test_llk.py).
* ``trans_dist``           — vectorised driver returning (log p0, E(K)) per
                             pair, matching transcluster.hpp:240-287.
* ``expected_k``           — E(K) accumulated over k until the analytic upper
                             bound (transcluster.hpp:173-188) tightens below
                             the requested precision, k capped at 10000
                             (transcluster.hpp:191-238).

Vectorised redesign
-------------------
The reference memoises per-(N, k, delta) log-probs in hash maps and loops
pair-by-pair.  Here the unique (N, delta) pairs are batched into fixed-shape
arrays and the k-loop becomes ONE vectorised ``lax.while_loop`` whose body is
O(1) per lane: the per-k "integral"

    I(M) = sum_{i=0..M} delta^(M-i) / ((M-i)! (lamb+beta)^(i+1)),  M = N+k

satisfies the recurrence  I(M) = delta^M/(M! (lamb+beta)) + I(M-1)/(lamb+beta)
carried in log space, so no O(N+k) inner sum is re-evaluated per k (the
reference recomputes it each k: transcluster.hpp:152-158).

Precision: float64 on the JAX CPU backend.  This is a small scalar workload
next to the all-pairs SNP kernel on the accelerator; whether it runs faster
in f64 on the GPU is not measured yet.

delta == 0 quirk: the reference computes ``upper_bound_E`` with
``log(lamb*delta) = -inf`` and ``0 * -inf = NaN``, so ``diff_bound`` is NaN
and the k-loop exits after k=1, giving E(K) = P(k=1|N).  The NaN arises here
through the identical expression, reproducing the behaviour bit-for-bit.
"""

from __future__ import annotations

import math
from datetime import date
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

SECONDS_IN_YEAR = 31556952.0  # reference tracs/transcluster.py:5

def _cpu():
    """The f64 host backend device — resolved lazily so importing the
    package never initialises XLA backends (jax.distributed.initialize
    must run first in multi-process programs), and LOCAL so the pinned
    jits stay process-local under a multi-process runtime
    (jax.devices()[0] would be another process's device on rank > 0)."""
    return jax.local_devices(backend="cpu")[0]

_K_CAP = 10000  # reference transcluster.hpp:207: while (... && k<10000)


# ---------------------------------------------------------------------------
# public scalar API — faithful to the reference's first variant
# ---------------------------------------------------------------------------

def lprob_k_given_N(N, k, delta, lamb, beta, lgamma):
    """Log-probability of k intermediate hosts given N SNPs and time gap delta.

    Matches reference ``lprob_k_given_N`` (src/transcluster.hpp:90-129),
    including the passed-in lgamma table and the i-ascending logaddexp
    accumulation order.  Returns (lprob, lhs).
    """
    lgamma = np.asarray(lgamma, dtype=np.float64)
    N = int(N)
    k = int(k)
    delta = float(delta)
    lamb = float(lamb)
    beta = float(beta)

    if delta > 0:
        lprob = (N + 1) * math.log(lamb) - delta * (lamb + beta) + k * math.log(beta) - lgamma[k + 1]

        pois_cdf = -math.inf
        for i in range(N + 1):
            pois_cdf = np.logaddexp(i * math.log(lamb * delta) - lgamma[i + 1], pois_cdf)
        pois_cdf -= lamb * delta
        lprob -= pois_cdf

        integral = -math.inf
        for i in range(N + k + 1):
            integral = np.logaddexp(
                lgamma[N + k + 1]
                - lgamma[i + 1]
                - lgamma[N + k - i + 1]
                + (N + k - i) * math.log(delta)
                + lgamma[i + 1]
                - (i + 1) * math.log(lamb + beta),
                integral,
            )
        integral -= lgamma[N + 1]
        lhs = lprob
        lprob += integral
    else:
        lprob = (
            (N + 1) * math.log(lamb)
            + k * math.log(beta)
            + lgamma[N + k + 1]
            - lgamma[N + 1]
            - lgamma[k + 1]
            - (N + k + 1) * math.log(lamb + beta)
        )
        lhs = lprob

    return float(lprob), float(lhs)


def upper_bound_E(delta, lamb, beta, N, lgamma=None):
    """Analytic upper bound on E(K) (reference transcluster.hpp:173-188).
    ``lgamma`` accepted for signature parity; lgamma is evaluated directly."""
    import math as _m

    pois = -_m.inf
    for i in range(int(N) + 1):
        pois = np.logaddexp(i * _m.log(lamb * delta) - _m.lgamma(i + 1), pois)
    return _m.exp(_m.log(beta) + delta * lamb + _m.log(N + 1) - (_m.log(lamb) + pois))


def expected_k(N, delta, lamb, beta, threshold_Ek=1e-6):
    """E(K): expected intermediate hosts for one (N SNPs, delta years) pair
    (reference transcluster.hpp:191-238 semantics, vectorised engine)."""
    _, eK = trans_dist([int(N)], [float(delta)], lamb, beta, threshold_Ek)
    return float(eK[0])


# ---------------------------------------------------------------------------
# vectorised engine (variant 2 semantics, used by trans_dist)
# ---------------------------------------------------------------------------

def _masked_logsumexp(terms: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """logsumexp over last axis with a boolean mask.  NaN in an unmasked term
    propagates (deliberate — see the delta==0 quirk in the module docstring)."""
    t = jnp.where(mask, terms, -jnp.inf)
    m = jnp.max(t, axis=-1)
    safe_m = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.sum(jnp.where(mask, jnp.exp(t - safe_m[..., None]), 0.0), axis=-1)
    out = safe_m + jnp.log(s)
    return jnp.where(jnp.isfinite(m), out, m)


def _log_pois_cdf_sum(N: jnp.ndarray, delta: jnp.ndarray, lamb: float, cap: int) -> jnp.ndarray:
    """log sum_{i=0..N} (lamb*delta)^i / i!   (NO exp(-lamb*delta) factor —
    both call sites in the reference handle that factor themselves;
    upper_bound_E omits it entirely, transcluster.hpp:178-185).

    The sum is truncated at ``cap`` terms; the caller chooses cap so the
    truncated tail is < e^-200 relative (Poisson pmf decays super-
    exponentially past its mode at lamb*delta).
    """
    i = jnp.arange(cap + 1, dtype=jnp.float64)
    # i=0 term is 0 * log(lamb*delta): NaN when delta == 0, exactly as in the
    # reference C++ (transcluster.hpp:105,147,182).
    terms = i[None, :] * jnp.log(lamb * delta)[:, None] - jax.lax.lgamma(i + 1.0)[None, :]
    mask = i[None, :] <= N[:, None]
    return _masked_logsumexp(terms, mask)


def _log_integral_direct(M: jnp.ndarray, delta: jnp.ndarray, log_lb: float, cap: int) -> jnp.ndarray:
    """log I(M) = log sum_{i=0..M} delta^(M-i)/((M-i)! (lamb+beta)^(i+1)),
    evaluated as the equivalent sum over j=M-i (decaying past j ~ delta*(l+b)),
    truncated at ``cap`` terms.  Valid for delta > 0 lanes only."""
    j = jnp.arange(cap + 1, dtype=jnp.float64)
    terms = (
        j[None, :] * jnp.log(delta)[:, None]
        - jax.lax.lgamma(j + 1.0)[None, :]
        - (M[:, None] - j[None, :] + 1.0) * log_lb
    )
    mask = j[None, :] <= M[:, None]
    return _masked_logsumexp(terms, mask)


def _lprob2_given_logI(N, k, delta, lamb, beta, log_pois, log_I):
    """Variant-2 log-prob (reference transcluster.hpp:131-170) with the
    Poisson-cdf log-sum and log-integral supplied.  Returns (lprob, lhs)."""
    lg = jax.lax.lgamma
    log_lamb = math.log(lamb)
    log_beta = math.log(beta)
    log_lb = math.log(lamb + beta)

    base_pos = (
        (N + 1.0) * log_lamb
        + k * log_beta
        + lg(N + k + 1.0)
        - lg(N + 1.0)
        - lg(k + 1.0)
        - delta * beta
        - log_pois  # variant-2 pois_cdf has NO -lamb*delta (transcluster.hpp:144-149)
    )
    lprob_pos = base_pos + log_I
    lhs_pos = base_pos

    lprob_zero = (
        (N + 1.0) * log_lamb
        + k * log_beta
        + lg(N + k + 1.0)
        - lg(N + 1.0)
        - lg(k + 1.0)
        - (N + k + 1.0) * log_lb
    )

    pos = delta > 0
    return (
        jnp.where(pos, lprob_pos, lprob_zero),
        jnp.where(pos, lhs_pos, lprob_zero),
    )


def _k_step(N, delta, log_pois, upper_bound, lamb, beta, log_lb, threshold_Ek, state):
    """One k iteration of the E(K) accumulation (reference k-loop body,
    transcluster.hpp:207-235).  Elementwise; identical math regardless of
    how lanes are batched, so compaction between blocks cannot change any
    lane's float sequence."""
    k, lprob, elprob, log_I, done = state
    M = N + k  # M = N + k for this iteration's integral
    log_I_next = jnp.logaddexp(
        M * jnp.log(delta) - jax.lax.lgamma(M + 1.0) - log_lb,
        log_I - log_lb,
    )
    lp_k, lhs_k = _lprob2_given_logI(N, k, delta, lamb, beta, log_pois, log_I_next)
    lprob_new = jnp.logaddexp(lprob, lp_k + jnp.log(k))
    elprob_new = jnp.logaddexp(
        elprob, lhs_k + jnp.log(k) + delta * (lamb + beta) - (N + k + 1.0) * log_lb
    )
    diff_bound = upper_bound - jnp.exp(elprob_new)
    # reference: while (diff_bound > threshold_Ek && k < 10000), k++ at end.
    # Guard: when upper_bound is so large that the tail can never be
    # resolved below threshold_Ek in f64 (upper*eps >> threshold), the
    # subtraction is pure cancellation noise and a spurious ulp-crossing
    # would exit with a garbage partial sum; exact math runs to the k cap
    # there, so we do too.  NaN upper_bound (the delta == 0 quirk) keeps
    # its immediate exit: NaN >= threshold is False -> bound stays usable
    # and NaN > threshold is False -> done.  No-op in the reference's
    # well-defined regime (upper_bound moderate, see PARITY.md).
    bound_usable = jnp.logical_not(upper_bound * 1e-12 >= threshold_Ek)
    done_new = (
        done
        | (bound_usable & jnp.logical_not(diff_bound > threshold_Ek))
        | (k + 1.0 >= _K_CAP)
    )
    keep = jnp.logical_not(done)
    return (
        jnp.where(keep, k + 1.0, k),
        jnp.where(keep, lprob_new, lprob),
        jnp.where(keep, elprob_new, elprob),
        jnp.where(keep, log_I_next, log_I),
        done_new,
    )


@partial(jax.jit, static_argnames=("lamb", "beta", "cap_pois", "cap_int"))
def _seed_batch(N, delta, *, lamb, beta, cap_pois, cap_int):
    """Per-lane loop-invariant seeds: Poisson log-sum, log I(N), p0 and the
    E(K) upper bound (NaN for delta == 0 lanes — the reference's
    single-iteration exit, see module docstring)."""
    N = N.astype(jnp.float64)
    delta = delta.astype(jnp.float64)
    log_lb = math.log(lamb + beta)
    # Poisson log-sum used by both the k-loop (variant-2 lprob) and the E(K)
    # upper bound; neither call site applies an exp(-lamb*delta) factor
    # (transcluster.hpp:144-149, 178-185).
    log_pois = _log_pois_cdf_sum(N, delta, lamb, cap_pois)
    log_I_N = _log_integral_direct(N, delta, log_lb, cap_int)
    p0, _ = _lprob2_given_logI(N, jnp.zeros_like(N), delta, lamb, beta, log_pois, log_I_N)
    upper_bound = jnp.exp(
        math.log(beta) + delta * lamb + jnp.log(N + 1.0) - (math.log(lamb) + log_pois)
    )
    return log_pois, log_I_N, p0, upper_bound


def _k_step_fast(N, delta, log_delta, log_pois, upper_bound, lg_N1,
                 lamb, beta, log_lb, threshold_Ek, state):
    """The k iteration with every lgamma carried as a recurrence
    (lgamma(x+1) = lgamma(x) + log(x)), loop-invariant logs hoisted, AND
    the two positive-term accumulators — E(K) = sum k*P(k) and the exit
    bound's partial sum — carried in LINEAR f64 instead of log space:
    both end in exp() anyway (the reference returns exp(lprob),
    transcluster.hpp:238, and compares exp(elprob) against the upper
    bound every step, transcluster.hpp:232), so summing exp(term)
    directly is the same math with ~2x fewer transcendentals per
    lane-step (each logaddexp is an exp + log1p; the per-step exit exp
    disappears entirely).  Differs from the reference's logaddexpd chain
    only in f64 rounding (a positive-term linear sum is the MORE accurate
    of the two); the monolithic oracle keeps the direct log-space form
    and the two are compared in tests/test_transcluster.py.

    Carries: lg_M1 = lgamma(N+k+1), lg_k1 = lgamma(k+1),
    log_k = log(k) (reused from the previous step's lgamma update).
    """
    k, e_sum, b_sum, log_I, lg_M1, lg_k1, log_k, done = state
    M = N + k
    log_I_next = jnp.logaddexp(M * log_delta - lg_M1 - log_lb, log_I - log_lb)

    base = (
        (N + 1.0) * math.log(lamb)
        + k * math.log(beta)
        + lg_M1
        - lg_N1
        - lg_k1
    )
    base_pos = base - delta * beta - log_pois
    lprob_zero = base - (M + 1.0) * log_lb
    pos = delta > 0
    lp_k = jnp.where(pos, base_pos + log_I_next, lprob_zero)
    lhs_k = jnp.where(pos, base_pos, lprob_zero)

    e_term = jnp.exp(lp_k + log_k)
    e_sum_new = e_sum + e_term
    b_sum_new = b_sum + jnp.exp(
        lhs_k + log_k + delta * (lamb + beta) - (M + 1.0) * log_lb
    )
    diff_bound = upper_bound - b_sum_new
    # same exit rule + cancellation guard as _k_step (see comment there)
    bound_usable = jnp.logical_not(upper_bound * 1e-12 >= threshold_Ek)
    # Extended-regime early exit, exact in f64: when the bound is unusable
    # the reference-semantics loop runs to the k cap, but once the k*P(k)
    # terms have decayed below ~ulp(e_sum) every remaining add is a no-op
    # in double precision (the tail is geometrically decaying, so it sums
    # to O(one term)); stopping there returns the bit-identical e_sum the
    # full 10000-step loop would.  The e_sum > 0 guard keeps lanes whose
    # early terms underflow (mode far to the right) running until the mass
    # appears.  Verified against the cap-running oracle in
    # tests/test_transcluster.py::test_extended_regime_tiny_term_exit.
    tiny = (e_sum > 0.0) & (e_term <= e_sum * 1e-19)
    done_new = (
        done
        | (bound_usable & jnp.logical_not(diff_bound > threshold_Ek))
        | (jnp.logical_not(bound_usable) & tiny)
        | (k + 1.0 >= _K_CAP)
    )
    keep = jnp.logical_not(done)
    log_k1 = jnp.log(k + 1.0)
    return (
        jnp.where(keep, k + 1.0, k),
        jnp.where(keep, e_sum_new, e_sum),
        jnp.where(keep, b_sum_new, b_sum),
        jnp.where(keep, log_I_next, log_I),
        jnp.where(keep, lg_M1 + jnp.log(M + 1.0), lg_M1),
        jnp.where(keep, lg_k1 + log_k1, lg_k1),
        jnp.where(keep, log_k1, log_k),
        done_new,
    )


@partial(jax.jit, static_argnames=("lamb", "beta", "threshold_Ek", "n_steps"))
def _k_block(N, delta, log_delta, log_pois, upper_bound, lg_N1,
             k, e_sum, b_sum, log_I, lg_M1, lg_k1, log_k, done,
             *, lamb, beta, threshold_Ek, n_steps):
    """Run ``n_steps`` k iterations for the still-active lanes (lax.scan)."""
    log_lb = math.log(lamb + beta)
    step = partial(_k_step_fast, N, delta, log_delta, log_pois, upper_bound,
                   lg_N1, lamb, beta, log_lb, threshold_Ek)

    def body(state, _):
        return step(state), None

    state, _ = jax.lax.scan(
        body, (k, e_sum, b_sum, log_I, lg_M1, lg_k1, log_k, done), None,
        length=n_steps,
    )
    return state


@partial(jax.jit, static_argnames=("lamb", "beta", "threshold_Ek", "cap_pois", "cap_int"))
def _trans_dist_batch(N, delta, *, lamb, beta, threshold_Ek, cap_pois, cap_int):
    """Monolithic engine: seeds + one batch-wide while_loop.  Kept as the
    oracle for the blocked/compacting production driver below (the slowest
    lane stalls the whole batch here, so trans_dist() doesn't use it)."""
    N = N.astype(jnp.float64)
    delta = delta.astype(jnp.float64)
    log_lb = math.log(lamb + beta)
    log_pois, log_I_N, p0, upper_bound = _seed_batch(
        N, delta, lamb=lamb, beta=beta, cap_pois=cap_pois, cap_int=cap_int
    )
    step = partial(_k_step, N, delta, log_pois, upper_bound,
                   lamb, beta, log_lb, threshold_Ek)

    def cond(state):
        return jnp.logical_not(jnp.all(state[4]))

    ninf = jnp.full_like(N, -jnp.inf)
    state0 = (jnp.ones_like(N), ninf, ninf, log_I_N, jnp.zeros_like(N, dtype=bool))
    _, lprob, _, _, _ = jax.lax.while_loop(cond, lambda s: step(s), state0)
    return p0, jnp.exp(lprob)


def _sum_cap(peak: float, n_max: int) -> int:
    """Number of series terms so the truncated tail is ~e^-200 of the total."""
    cap = int(peak + 30.0 * math.sqrt(peak + 1.0) + 64.0)
    return max(1, min(n_max, cap))


_SEED_CHUNK = 8192  # lanes per seed-series evaluation (bounds the [B, cap] temp)


def _pow2(n: int, lo: int = 64) -> int:
    """Bucket to a power of two (bounds the number of jit shapes)."""
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def trans_dist(snpdiff, datediff, lamb, beta, threshold_Ek=1e-6):
    """Vectorised (log p0, E(K)) per pair — reference trans_dist
    (src/transcluster.hpp:240-287).  The reference's per-(N, delta) hash-map
    memoisation becomes a host-side unique + device batches + scatter.

    Engine shape: lanes sorted by (delta, N) are seeded in chunks (so the
    truncated-series caps adapt to each chunk's own peak instead of the
    global worst case), then the k-loop runs in geometrically growing
    blocks with ACTIVE-LANE COMPACTION between blocks — a lane that needs
    k=10000 (small N, large lamb*delta: the reference's own cap,
    transcluster.hpp:207) no longer stalls every other lane the way one
    batch-wide while_loop does.  Per-lane math is elementwise and
    identical regardless of batching, so results match the monolithic
    engine to f64.
    """
    snpdiff = np.asarray(snpdiff, dtype=np.int64)
    datediff = np.asarray(datediff, dtype=np.float64)
    if snpdiff.size == 0:
        return np.zeros(0), np.zeros(0)

    keys = np.stack([snpdiff.astype(np.float64), datediff], axis=1)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    uN = uniq[:, 0]
    ud = uniq[:, 1]
    m = uN.shape[0]

    order = np.lexsort((uN, ud))
    sN = uN[order]
    sd = ud[order]
    lamb = float(lamb)
    beta = float(beta)
    threshold_Ek = float(threshold_Ek)

    log_pois = np.empty(m)
    log_I0 = np.empty(m)
    p0_s = np.empty(m)
    upper = np.empty(m)
    eK_s = np.empty(m)

    with jax.default_device(_cpu()):
        # ---- phase 1: loop-invariant seeds, chunked with adaptive caps
        for s in range(0, m, _SEED_CHUNK):
            e = min(m, s + _SEED_CHUNK)
            cN, cd = sN[s:e], sd[s:e]
            B = _pow2(e - s)
            cap_pois = _pow2(_sum_cap(lamb * float(cd.max()), int(cN.max())), lo=8)
            cap_int = _pow2(
                _sum_cap(float(cd.max()) * (lamb + beta), int(cN.max()) + _K_CAP), lo=8
            )
            pN = np.zeros(B)
            pd = np.zeros(B)
            pN[: e - s] = cN
            pd[: e - s] = cd
            lp, li, pp, ub = _seed_batch(
                jnp.asarray(pN), jnp.asarray(pd),
                lamb=lamb, beta=beta, cap_pois=cap_pois, cap_int=cap_int,
            )
            log_pois[s:e] = np.asarray(lp)[: e - s]
            log_I0[s:e] = np.asarray(li)[: e - s]
            p0_s[s:e] = np.asarray(pp)[: e - s]
            upper[s:e] = np.asarray(ub)[: e - s]

        # ---- phase 2: blocked k loop with active-lane compaction
        from scipy.special import gammaln

        with np.errstate(divide="ignore"):
            log_sd = np.log(sd)  # -inf for delta == 0 lanes (the NaN quirk path)
        lg_N1_all = gammaln(sN + 1.0)
        k_st = np.ones(m)
        e_st = np.zeros(m)          # E(K) partial sum (linear f64)
        b_st = np.zeros(m)          # exit-bound partial sum (linear f64)
        li_st = log_I0.copy()
        lgM_st = gammaln(sN + 2.0)  # lgamma(N+k+1) at k=1
        lgk_st = np.zeros(m)        # lgamma(k+1)   at k=1
        logk_st = np.zeros(m)       # log(k)        at k=1
        active = np.arange(m)
        n_steps = 8
        while active.size:
            a = active.size
            B = _pow2(a)

            def padded(vals, fill=0.0, dtype=np.float64):
                buf = np.full(B, fill, dtype=dtype)
                buf[:a] = vals
                return jnp.asarray(buf)

            res = _k_block(
                padded(sN[active]), padded(sd[active]), padded(log_sd[active]),
                padded(log_pois[active]), padded(upper[active]),
                padded(lg_N1_all[active]),
                padded(k_st[active], fill=1.0), padded(e_st[active]),
                padded(b_st[active]), padded(li_st[active]),
                padded(lgM_st[active]), padded(lgk_st[active]),
                padded(logk_st[active]),
                padded(np.zeros(a, bool), fill=True, dtype=bool),
                lamb=lamb, beta=beta, threshold_Ek=threshold_Ek, n_steps=n_steps,
            )
            k_n, e_n, b_n, li_n, lgM_n, lgk_n, logk_n, dn_n = (
                np.asarray(r)[:a] for r in res
            )
            k_st[active] = k_n
            e_st[active] = e_n
            b_st[active] = b_n
            li_st[active] = li_n
            lgM_st[active] = lgM_n
            lgk_st[active] = lgk_n
            logk_st[active] = logk_n
            fin = dn_n
            eK_s[active[fin]] = e_n[fin]
            active = active[~fin]
            n_steps = min(n_steps * 2, 512)

    p0_u = np.empty(m)
    eK_u = np.empty(m)
    p0_u[order] = p0_s
    eK_u[order] = eK_s
    return p0_u[inverse], eK_u[inverse]


class TransClusterCache:
    """Process-level memo for (N, delta) -> (log p0, E(K)) across streamed
    row blocks — the streaming analogue of the reference's in-call hash maps
    (transcluster.hpp:245-246), so repeated pairs cost one device eval."""

    def __init__(self, lamb, beta, threshold_Ek=1e-6):
        self.lamb = float(lamb)
        self.beta = float(beta)
        self.threshold_Ek = float(threshold_Ek)
        self._memo: dict[tuple[int, float], tuple[float, float]] = {}

    def lookup(self, snpdiff, datediff):
        snpdiff = np.asarray(snpdiff, dtype=np.int64)
        datediff = np.asarray(datediff, dtype=np.float64)
        if snpdiff.size == 0:
            return np.zeros(0), np.zeros(0)
        # dedup in numpy first: Python dict work is O(unique), not O(pairs)
        keys = np.stack([snpdiff.astype(np.float64), datediff], axis=1)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        tuples = [(int(n), float(d)) for n, d in uniq]
        novel = [t for t in tuples if t not in self._memo]
        if novel:
            ns = np.array([k[0] for k in novel], dtype=np.int64)
            ds = np.array([k[1] for k in novel], dtype=np.float64)
            p0, eK = trans_dist(ns, ds, self.lamb, self.beta, self.threshold_Ek)
            for k, p, e in zip(novel, p0, eK):
                self._memo[k] = (float(p), float(e))
        vals = np.array([self._memo[t] for t in tuples], dtype=np.float64)
        return vals[inverse, 0], vals[inverse, 1]


# ---------------------------------------------------------------------------
# date glue — reference tracs/transcluster.py
# ---------------------------------------------------------------------------

def calculate_trans_prob(
    sparse_snp_dist,
    sample_dates,
    K,
    lamb,
    beta,
    samplenames=None,
    log=False,
    precision=0.01,
):
    """Python glue matching reference tracs/transcluster.py:8-41 (the ``K``
    parameter is accepted-but-unused there too)."""
    i = np.array(sparse_snp_dist[0])
    j = np.array(sparse_snp_dist[1])
    d = np.array(sparse_snp_dist[2], dtype=int)

    nsamples = max(max(sparse_snp_dist[0]), max(sparse_snp_dist[1]))

    reftime = date.fromisoformat("1970-01-01")
    time_array = np.array(
        [
            (sample_dates[samplenames[s]][1] - reftime).total_seconds()
            for s in range(nsamples + 1)
        ]
    )
    time_diff = np.abs(time_array[i] - time_array[j]) / SECONDS_IN_YEAR

    p0, eK = trans_dist(d, time_diff, lamb, beta, precision)

    if not log:
        p0 = np.exp(p0)

    return p0, eK, time_diff
