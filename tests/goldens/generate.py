"""Regenerate the golden images (CPU backend, deterministic seeds).

Run after an INTENTIONAL radiometric change, inspect the PNGs by eye, and
commit the updated .npz + .png files:

    python tests/goldens/generate.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main() -> None:
    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.gallery import CONFIGS, golden_config

    out_dir = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(CONFIGS):
        scene, cam, settings = golden_config(name)
        img = np.asarray(render_mod.render(scene, cam, settings))
        np.savez_compressed(
            os.path.join(out_dir, name + ".npz"), img=img.astype(np.float16)
        )
        film_mod.write_png(os.path.join(out_dir, name + ".png"), img)
        print(f"{name}: mean={img.mean():.4f} max={img.max():.3f}", flush=True)

    # compat_go demo (reference WriteImage semantics, film.go:142-179)
    from gopbrt_tpu.models.gallery import render_compat_go_demo

    img = render_compat_go_demo()
    np.savez_compressed(
        os.path.join(out_dir, "compat_go_demo.npz"), img=img.astype(np.float16)
    )
    film_mod.write_png(os.path.join(out_dir, "compat_go_demo.png"), img)
    print(f"compat_go_demo: mean={img.mean():.4f}", flush=True)


if __name__ == "__main__":
    main()
