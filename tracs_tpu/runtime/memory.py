"""Device-memory byte budgets for the sweep planners and engine gates.

Every budget is a share of the device allocator's limit
(``memory_stats()["bytes_limit"]``), so the plans scale with the card.  The
shares were set on a 16 GiB device and are kept as they were there:

* ``device_split`` (12/16): transient bytes for deriving the split layout
  on the device (raw planes + exclusive planes + N mask live at once);
* ``chunk`` (5/16): one gram chunk's unpacked int8 channels
  (``ops/pairsnp.py::plan_chunks``);
* ``device`` (14/16): whole-device bytes the mesh ring engine may assume
  for operands, stripes and chunk temps (``RingCoo.fits``);
* ``ring_stripe`` (4/16): the ring engine's stripe tensors, also the
  feasibility line of the auto-mesh planner.

A backend that reports no limit (the CPU) gets those 16 GiB values as they
stand.  Each budget keeps its environment override, read on every call.
"""

from __future__ import annotations

import dataclasses
import functools
import os


@dataclasses.dataclass(frozen=True)
class MemoryBudgets:
    device_split: int
    chunk: int
    device: int
    ring_stripe: int


#: the budgets of a 16 GiB device, used where the backend reports no limit
CPU_BUDGETS = MemoryBudgets(
    device_split=12 << 30, chunk=5 << 30, device=14 << 30, ring_stripe=4 << 30
)
_SHARE_BASE = 16 << 30

_ENV_OVERRIDES = {
    "device_split": "TRACS_TPU_DEVICE_SPLIT_BYTES",
    "chunk": "TRACS_TPU_CHUNK_BYTES",
    "device": "TRACS_TPU_DEVICE_HBM_BYTES",
    "ring_stripe": "TRACS_TPU_RING_BYTES",
}


@functools.lru_cache(maxsize=1)
def device_bytes_limit() -> int | None:
    """The first local device's allocator limit in bytes, or None when the
    backend does not report one."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    limit = (stats or {}).get("bytes_limit")
    return int(limit) if limit else None


def memory_budgets() -> MemoryBudgets:
    """The byte budgets for the first local device, with any environment
    overrides applied."""
    bytes_limit = device_bytes_limit()
    if bytes_limit is None:
        budgets = CPU_BUDGETS
    else:
        budgets = MemoryBudgets(
            *(v * bytes_limit // _SHARE_BASE for v in dataclasses.astuple(CPU_BUDGETS))
        )
    overrides = {
        field: int(os.environ[var])
        for field, var in _ENV_OVERRIDES.items()
        if os.environ.get(var)
    }
    return dataclasses.replace(budgets, **overrides) if overrides else budgets
