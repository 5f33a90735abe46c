"""Multi-host (multi-process) initialization.

The reference has no distributed support at all (SURVEY.md §2.3). Here
multi-host data parallelism falls out of the mesh design: call
`maybe_initialize()` before any jax use on each host; `create_mesh` then
sees every device of every host and the existing NamedSharding batch
layout shards the *global* batch across hosts; XLA inserts the gradient
all-reduces.

On a single host this is a no-op, so every entry point can call it
unconditionally.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import jax

log = logging.getLogger(__name__)

_INITIALIZED = False


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process.

    Explicit args win; otherwise standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) are
    used. Returns True when
    distributed mode is active.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if not coordinator_address and num_processes in (None, 1):
        return False  # single process

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True
    log.info("jax.distributed initialized: process %d/%d, %d local / %d "
             "global devices", jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return True


def is_primary() -> bool:
    """True on the process that should write checkpoints/artifacts."""
    try:
        return jax.process_index() == 0
    except RuntimeError:
        return True
