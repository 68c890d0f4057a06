"""Multi-host initialisation and mesh construction.

The reference has no distributed backend at all (SURVEY.md §2.3); scaling
past one host here is standard JAX SPMD: every host runs the same program,
``jax.distributed.initialize`` wires the processes together, and the dp x sp
mesh spans all devices — dp (sample-block ring) crosses hosts over the
network, sp (position shards) stays within a host.

Typical launch (per host):

    TRACS_TPU_COORDINATOR=host0:8476 TRACS_TPU_NUM_PROCESSES=4 \
    TRACS_TPU_PROCESS_ID=$RANK  python -m tracs_tpu distance ...

or programmatically::

    from tracs_tpu.parallel.multihost import initialize, global_mesh
    initialize()                       # no-op on a single host
    mesh = global_mesh(sp=2)
"""

from __future__ import annotations

import logging
import os

import jax

from tracs_tpu.parallel.mesh import make_mesh


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialise jax.distributed from args or TRACS_TPU_* env vars.
    Returns True if a multi-process runtime was set up, False for the
    single-host no-op path."""
    coordinator = coordinator or os.environ.get("TRACS_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("TRACS_TPU_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid_env = os.environ.get("TRACS_TPU_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None

    if not coordinator or num_processes <= 1:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    logging.info(
        "jax.distributed initialised: process %s/%s, %s global devices",
        jax.process_index(), jax.process_count(), len(jax.devices()),
    )
    return True


def global_mesh(sp: int = 1):
    """A dp x sp mesh over ALL global devices (multi-host aware)."""
    n = len(jax.devices())
    if n % sp:
        raise ValueError(f"{n} devices not divisible by sp={sp}")
    return make_mesh(n // sp, sp)
