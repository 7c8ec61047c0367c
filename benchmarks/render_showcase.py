"""Render the 1080p demo showcase PNG (assets/demo_1080p.png).

The reference ships a demo image.png in its README; this is ours — the
demo scene from a sane viewpoint (the reference's own hardcoded demo
camera has a quirky [0,1]^2 screen-window crop that postdates its
checked-in image).  Checked in for human eyeballing across rounds.

    python benchmarks/render_showcase.py [--spp N]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "demo_1080p.png"))
    args = ap.parse_args()

    from gopbrt_tpu.models import camera as cam_mod
    from gopbrt_tpu.models import film, render
    from gopbrt_tpu.models.demo import build_demo_scene
    from gopbrt_tpu.ops import geom

    scene = build_demo_scene()
    cam = cam_mod.perspective_camera(
        geom.look_at([60.0, 40.0, 120.0], [30.0, 5.0, 20.0], [0.0, 1.0, 0.0]),
        args.width, args.height, fov_deg=60.0,
    )
    settings = render.RenderSettings(
        width=args.width, height=args.height, spp=args.spp, max_depth=5,
        samples_per_pass=1, seed=4,
    )
    img = np.asarray(render.render(scene, cam, settings))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    film.write_png(args.out, img)
    print(f"{args.out}: {args.width}x{args.height} spp{args.spp} "
          f"mean={img.mean():.4f} max={img.max():.3f}")


if __name__ == "__main__":
    main()
