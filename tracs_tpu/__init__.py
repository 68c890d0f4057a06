"""tracs_tpu — a GPU-accelerated transmission-distance engine.

A from-scratch JAX/XLA framework with the capabilities of the TRACS
pipeline (reference: gtonkinhill/tracs): it estimates pairwise transmission
distances between bacterial / viral / metagenomic samples by

  1. aligning reads against one or more reference genomes (``align`` stage,
     host-side orchestration of external aligners),
  2. converting pileups into coverage-aware posterior allele calls with an
     empirical-Bayes Dirichlet-multinomial model (``models.dirichlet``),
  3. computing all-pairs SNP distances over bit-packed one-hot alignments
     as int8 GEMMs on the accelerator (``ops.pairsnp``),
  4. converting SNP + sampling-date differences into direct-transmission
     probabilities and the expected number of intermediate hosts
     (``models.transcluster``), and
  5. grouping samples into transmission clusters (``stages.cluster``).

Precision policy
----------------
x64 is enabled globally: the transcluster and Dirichlet-multinomial numerics
require float64 to hit the reference golden values at 1e-6 tolerance
(cf. reference tests/test_llk.py:27-28).  Those models run on the JAX CPU
backend, so a CPU backend is always registered beside the accelerator.
The device kernels use explicit 8/16/32-bit dtypes and never place f64 on
the accelerator.
"""

import os

import jax

# The float64 model numerics (transcluster, Dirichlet-multinomial) run on the
# JAX CPU backend; make sure one exists even when JAX_PLATFORMS names only an
# accelerator.  Updating the config (not the environment) is what works when
# jax was imported before this module; it is safe until backends initialise.
_REQUESTED_PLATFORM = None  # first entry of JAX_PLATFORMS when not "cpu"
try:
    _platforms = jax.config.jax_platforms
    if _platforms:
        _first = _platforms.split(",")[0]
        if _first != "cpu":
            _REQUESTED_PLATFORM = _first
        if "cpu" not in _platforms.split(","):
            jax.config.update("jax_platforms", _platforms + ",cpu")
except Exception:  # pragma: no cover - backends already initialised
    pass


class PlatformFallbackError(RuntimeError):
    """JAX_PLATFORMS named an accelerator, but JAX came up on the CPU."""


def check_platform() -> None:
    """Raise PlatformFallbackError when JAX_PLATFORMS named an accelerator
    and the default backend came up as the CPU.  JAX skips a requested
    platform whose device is missing (``cuda`` with no visible GPU) and
    falls through to the ``cpu`` entry appended above, which would run the
    device kernels on the host without a word.

    Lazy: only backends that already initialised are inspected, so a
    host-only command (plot, cluster, doctor) pays no accelerator start-up
    for this check."""
    if not _REQUESTED_PLATFORM:
        return
    try:  # private, so fail-safe: no check beats a forced backend init
        from jax._src import xla_bridge as _xb

        initialised = bool(getattr(_xb, "_backends", None))
    except Exception:  # pragma: no cover - jax internals moved
        initialised = False
    if initialised and jax.default_backend() == "cpu":
        raise PlatformFallbackError(
            f"JAX_PLATFORMS requested {_REQUESTED_PLATFORM!r} but that "
            "backend did not initialise and JAX fell back to the CPU. "
            "Check the accelerator, or set JAX_PLATFORMS=cpu to run on "
            "the CPU on purpose."
        )


jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  When JAX_COMPILATION_CACHE_DIR is set, JAX
# reads it itself and nothing is set here; otherwise the cache lives at a
# fixed path inside the checkout (the path is part of the cache key, so a
# moving directory would never hit).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"

from tracs_tpu.ops.packing import (  # noqa: E402
    PackedAlignment,
    pack_sequences,
    pack_fasta,
    iupac_code_for_mask,
)
from tracs_tpu.ops.pairsnp import pairsnp, snp_distance_dense  # noqa: E402
from tracs_tpu.models.transcluster import (  # noqa: E402
    lprob_k_given_N,
    trans_dist,
    calculate_trans_prob,
)
from tracs_tpu.models.dirichlet import (  # noqa: E402
    find_dirichlet_priors,
    calculate_posteriors,
)

__all__ = [
    "PackedAlignment",
    "pack_sequences",
    "pack_fasta",
    "iupac_code_for_mask",
    "pairsnp",
    "snp_distance_dense",
    "lprob_k_given_N",
    "trans_dist",
    "calculate_trans_prob",
    "find_dirichlet_priors",
    "calculate_posteriors",
    "__version__",
]
