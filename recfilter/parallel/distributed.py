"""Multi-process initialization and (data, seq) mesh construction.

The reference is a single-process, single-GPU library (SURVEY §2.6 — no
NCCL/MPI anywhere); this module is the capability it lacks: a
``jax.distributed`` entry point and a mesh builder that keeps the
carry-exchange (sequence) axis on the GPUs of one process — all joined to
all by NVLink, so any device order serves — and lays the line/batch (data)
axis across processes, where only the collective-free data-parallel work
crosses the slower inter-host network (SURVEY §5.8 blueprint).

Single-process use (tests, one host driving its cards) needs no
initialization — every helper works on the local device set.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Bring up the multi-process runtime (idempotent).

    Nothing in a plain GPU host announces a cluster, so the coordinator
    (``"host:port"``), the process count and this process's id must be
    given. Returns True when a multi-process runtime was (or already is)
    initialized, False when no coordinator was given (single-process run).
    """
    global _initialized
    if _initialized or jax.process_count() > 1:
        _initialized = True
        return True
    if coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True
    return True


def pod_mesh(
    data: int = 0,
    seq: int = 0,
    data_name: str = "data",
    seq_name: str = "seq",
    devices=None,
) -> Mesh:
    """Build a (data, seq) mesh over all devices.

    ``data``/``seq`` of 0 auto-solve: seq takes the devices of one process
    (so the latency-bound carry exchange stays on NVLink within a host)
    and data spans processes. Pass explicit sizes to override. Devices are
    laid process-major, so a seq row never crosses a process boundary
    when ``seq`` divides the local device count.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if not data and not seq:
        seq = max(1, jax.local_device_count())
        while n % seq:
            seq //= 2
        data = n // seq
    elif not data:
        data = n // seq
    elif not seq:
        seq = n // data
    if data * seq != n:
        raise ValueError(
            f"mesh {data}x{seq} does not cover the {n} available devices"
        )
    devices.sort(key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devices).reshape(data, seq), (data_name, seq_name))
