"""Device-mesh helpers: sample-block (dp) x genome-position (sp) meshes.

The reference's parallelism is an OpenMP parallel-for over pair-matrix rows
on one CPU (reference src/pairsnp.hpp:380-432).  The device-mesh equivalents:

* ``dp`` — sample-block data parallelism: each device owns a block of
  samples; blocks rotate around a ring (``ppermute``) so every pair of
  blocks meets exactly once per sweep.  This replaces the OpenMP row loop
  and scales all-pairs workloads past one chip's HBM.
* ``sp`` — genome-position sharding: the packed position axis is split
  across devices; per-pair counts are commutative sums of per-shard
  popcounts/grams, reduced with ``psum``.  This is the sequence-parallel
  axis for very long or many-reference alignments.

Multi-host: ``jax.distributed.initialize()`` + the same mesh spanning all
processes.  The cards of one host are joined all to all (NVLink), so
``make_mesh`` takes devices in list order: no placement beats another.
"""

from __future__ import annotations

import math
import os

import jax
import numpy as np
from jax.sharding import Mesh

from tracs_tpu.runtime.memory import memory_budgets

# Ring arithmetic intensity: a ring step computes a [B, B] gram (B*5*32
# MACs per rotated operand word of 4 bytes => ~8*B int8 MACs/byte, genome-
# length independent).  Stripes thinner than this cannot hide the ring's
# operand rotation behind their own GEMM work, so the planner concedes
# devices to sp instead of slicing dp thinner.
_MIN_STRIPE_ROWS = int(os.environ.get("TRACS_TPU_MESH_MIN_STRIPE", "512"))


def _divisors(n: int) -> list[int]:
    out = set()
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            out.update((d, n // d))
    return sorted(out)


def best_mesh_shape(n_devices: int, n_samples: int | None = None, n_words: int | None = None):
    """Pick (dp, sp) for n_devices.

    dp (sample blocks) is the quadratic axis and wins by default: the
    per-device stripe output of the triangle ring scales as n^2/dp, so
    more dp strictly lowers HBM pressure.  Devices are conceded to sp
    (packed-word shards) when stripes would drop below _MIN_STRIPE_ROWS
    rows — too thin to hide the ring's operand rotation behind their own
    GEMM work (per-step intensity ~ 8*B MACs/rotated byte, independent of
    genome length) — which covers both the scarce-sample case and
    medium-n long-genome runs where position sharding cuts ring traffic.

    ``n_words`` (packed word count, ceil(L/32)) bounds the concession:
    sp never exceeds n_words // 8 (a position shard below 8 words is pure
    padding — the engines pad words to 8*sp), and shapes whose ring
    stripes would blow the ring-stripe budget
    (runtime/memory.py) are avoided when any feasible
    shape exists (none exists at very large n: then all-dp minimises the
    stripes and the streaming engine takes over from the ring anyway).
    """
    if n_devices <= 1:
        return 1, 1
    if n_samples is None:
        return n_devices, 1
    sp_cap = n_devices
    if n_words is not None:
        sp_cap = max(1, min(sp_cap, n_words // 8))

    def n_pad(dp):
        return -(-max(n_samples, 1) // dp) * dp

    cands = [d for d in _divisors(n_devices) if n_devices // d <= sp_cap]
    ring_budget = memory_budgets().ring_stripe
    feasible = [
        d for d in cands if 16 * n_pad(d) * (n_pad(d) // d) <= ring_budget
    ]
    pool = feasible or cands
    fat = [d for d in pool if -(-n_samples // d) >= _MIN_STRIPE_ROWS]
    # fat stripes available: take every device as a dp stripe (largest dp);
    # otherwise fewest, fattest stripes (smallest dp) and sp soaks the rest
    dp = max(fat) if fat else min(pool)
    return dp, n_devices // dp


def make_mesh(dp: int, sp: int = 1, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if dp * sp > len(devices):
        raise ValueError(f"mesh {dp}x{sp} needs {dp*sp} devices, have {len(devices)}")
    dev = np.asarray(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(dev, ("dp", "sp"))


def pad_to(x: int, mult: int) -> int:
    return int(math.ceil(x / mult) * mult)


def to_host(x) -> np.ndarray:
    """Device array -> host numpy, multi-process safe.

    A jax.Array whose shards live on other processes' devices is not fully
    addressable, so ``np.asarray`` raises; gather it to every host first
    (allgather via multihost_utils).  Fully-addressable arrays —
    everything in a single-process run, and replicated arrays in any run —
    take the plain zero-copy download."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def resolve_mesh(spec: str | None = "auto", *, n_samples: int | None = None,
                 n_words: int | None = None) -> Mesh | None:
    """Resolve a ``--mesh`` CLI / TRACS_TPU_MESH spec to a device mesh.

    * ``"auto"`` (or None): all visible devices, shaped by
      ``best_mesh_shape`` — pass ``n_samples``/``n_words`` (sample count
      and packed word count of the workload) so the dp/sp split is
      HBM- and genome-length-aware; returns None on a single device so
      callers keep the plain single-chip path.  Under multi-process it
      stays on this process's own chips (SPMD safety — see below).
    * ``"off"``: force single-device.
    * ``"DPxSP"`` (e.g. ``"4x2"``): explicit shape over the global device
      list (spans processes under jax.distributed).
    * ``"global"``: all GLOBAL devices, dp-major — the sanctioned
      cross-host spec for SPMD launches where every process runs the same
      program (tests/test_multihost.py runs it under real multi-process
      jax.distributed).
    """
    import os

    if spec is None:
        spec = os.environ.get("TRACS_TPU_MESH", "auto")
    spec = spec.strip().lower()
    if spec == "off":
        return None
    if spec == "global":
        n = len(jax.devices())
        if n <= 1:
            return None
        return make_mesh(*best_mesh_shape(n, n_samples, n_words))
    if spec == "auto":
        if jax.process_count() > 1:
            # SPMD safety: a global mesh is only valid when EVERY process
            # executes the same program (a proper multi-host launcher).
            # 'auto' therefore stays on this process's own chips; ask for an
            # explicit 'DPxSP' to span hosts.
            devices = jax.local_devices()
            if len(devices) <= 1:
                return None
            return make_mesh(
                *best_mesh_shape(len(devices), n_samples, n_words),
                devices=devices,
            )
        n = len(jax.devices())
        if n <= 1:
            return None
        return make_mesh(*best_mesh_shape(n, n_samples, n_words))
    try:
        dp, sp = (int(t) for t in spec.split("x"))
    except ValueError:
        raise ValueError(
            f"invalid mesh spec {spec!r}: expected 'auto', 'off' or 'DPxSP'"
        ) from None
    if dp * sp <= 1:
        return None
    return make_mesh(dp, sp)
