"""Multi-host entry path: ``jax.distributed`` initialization + global mesh.

The reference is single-process (SURVEY §2.3 — no MPI/NCCL/Gloo anywhere);
this module is the framework's multi-host story: one ``initialize()`` call
turns an N-process launch (one process per host, GPU or CPU/gloo) into a
global device mesh that the existing 1-D row-partition layer
(parallel/mesh.py, parallel/spmv.py) runs over unchanged — GSPMD inserts
the collectives from the same shardings.

Launch pattern (same script on every host):

    import pysolvers_tpu.parallel.distributed as dist
    dist.initialize("host0:9733", num_processes=4, process_id=i)
    mesh = dist.global_mesh()            # all devices across all processes
    A = shard_dia(H, mesh); ...          # identical single-host code

Env-var fallbacks (set by launchers): PST_COORDINATOR, PST_NUM_PROCESSES,
PST_PROCESS_ID.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

from .mesh import ROW_AXIS, make_mesh

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> None:
    """Initialize the multi-process runtime (idempotent).

    Pass the arguments or set PST_COORDINATOR / PST_NUM_PROCESSES /
    PST_PROCESS_ID (nothing detects a cluster automatically).
    """
    global _initialized
    if _initialized:
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("PST_COORDINATOR"))
    if num_processes is None and "PST_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PST_NUM_PROCESSES"])
    if process_id is None and "PST_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PST_PROCESS_ID"])
    kw = {}
    if coordinator_address is not None:
        kw.update(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    if local_device_ids is not None:
        kw.update(local_device_ids=local_device_ids)
    jax.distributed.initialize(**kw)
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def global_mesh(n_devices: Optional[int] = None):
    """1-D row mesh over ALL devices of ALL processes (jax.devices() is
    global after ``initialize``)."""
    return make_mesh(n_devices)


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()
