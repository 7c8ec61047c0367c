"""Worker process for the multi-host (multi-process) render test.

Launched by tests/test_distributed.py as ``python -m tests._distributed_worker
<coordinator> <process_id> <num_processes> <out.npy>``: initializes
``jax.distributed`` over a localhost coordinator (the DCN bring-up path,
parallel/shard.init_distributed), renders the gallery Cornell config on the
GLOBAL 2x4-virtual-CPU device mesh with the band-sharded SPMD renderer, and
writes the allgathered image so the parent can compare it with the
single-process render.
"""

import os
import sys


def main() -> int:
    coordinator, pid, nprocs, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()

    import jax

    # the workers stay on the CPU: a second JAX process on an accelerator
    # would fail for want of the memory the first one reserved
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    from gopbrt_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    # DCN bring-up MUST precede importing the renderer (whose import
    # initializes the XLA backend) — hence the import-light dist module
    from gopbrt_tpu.parallel.dist import init_distributed

    ok = init_distributed(
        coordinator_address=coordinator, num_processes=nprocs, process_id=pid
    )
    assert ok and jax.process_count() == nprocs, "distributed init failed"

    from gopbrt_tpu.parallel import shard  # noqa: F401 (renderer import)
    assert len(jax.devices()) == 4 * nprocs  # global
    assert len(jax.local_devices()) == 4

    import numpy as np
    from jax.experimental import multihost_utils

    from gopbrt_tpu.models.gallery import config2
    from gopbrt_tpu.models.render import RenderSettings

    scene, camera, settings = config2(48, 48)
    settings = settings._replace(spp=4, samples_per_pass=2, max_depth=3)
    mesh = shard.make_mesh(data=4 * nprocs, sample=1)
    img = shard.render_sharded(mesh, scene, camera, settings)
    img_full = np.asarray(multihost_utils.process_allgather(img, tiled=True))
    if pid == 0:
        np.save(out, img_full)
    multihost_utils.sync_global_devices("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
