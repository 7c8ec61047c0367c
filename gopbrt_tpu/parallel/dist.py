"""Multi-host (DCN) bring-up — import-light on purpose.

``jax.distributed.initialize`` must run BEFORE anything initializes the
XLA backend, and importing the renderer does (ops/geom.py builds jnp
constants at import).  This module imports only jax, so workers can do

    from gopbrt_tpu.parallel.dist import init_distributed
    init_distributed(coordinator_address=..., num_processes=..., process_id=...)

first and import the renderer after.  parallel/shard.py re-exports it.
"""

from __future__ import annotations

import os

import jax


def init_distributed(**kwargs) -> bool:
    """Initialize JAX multi-host coordination (``jax.distributed``) when the
    environment provides a coordinator (JAX_COORDINATOR_ADDRESS or explicit
    kwargs) — the bring-up for multi-host runs; collectives inside
    shard_map need no further setup.  Returns True when initialized.

    Single-host runs (no coordinator configured) are a no-op: the in-process
    mesh over local devices is already fully functional.

    Exercised end-to-end by tests/test_distributed.py: two processes, a
    localhost coordinator, and the band-sharded renderer with its halo
    ppermutes crossing the process boundary.
    """
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return True  # already initialized (checked WITHOUT touching the
        # backend: jax.process_count() would initialize XLA and make a
        # later jax.distributed.initialize illegal)
    has_env = os.environ.get("JAX_COORDINATOR_ADDRESS") or kwargs.get(
        "coordinator_address"
    )
    if not has_env:
        return False
    jax.distributed.initialize(**kwargs)
    return True
