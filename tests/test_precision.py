"""Every matrix product traced on the main path asks for full f32.

At default precision a GPU may run f32 matrix products in TF32 (a 10-bit
mantissa), which moves ray transforms and camera rays by ~1e-3.  Each
``dot_general`` in a traced render pass (and in camera construction) must
carry ``Precision.HIGHEST`` on both operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

from gopbrt_tpu.models import film as film_mod
from gopbrt_tpu.models import gallery
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene
from gopbrt_tpu.models.scene import SceneBuilder
from gopbrt_tpu.ops import geom

W, H = 16, 9
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _sub_jaxprs(param):
    if isinstance(param, jcore.ClosedJaxpr):
        yield param.jaxpr
    elif isinstance(param, jcore.Jaxpr):
        yield param
    elif isinstance(param, (tuple, list)):
        for p in param:
            yield from _sub_jaxprs(p)


def _dot_precisions(jaxpr):
    """precision params of every dot_general, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for sub in _sub_jaxprs(p):
                out += _dot_precisions(sub)
    return out


def _pass_jaxpr(scene, cam):
    settings = render_mod.RenderSettings(width=W, height=H, spp=1, max_depth=2)
    return jax.make_jaxpr(
        lambda sc, c: render_mod.render_pass(
            sc, c, film_mod.new_film(W, H), settings, jnp.uint32(0))
    )(scene, cam).jaxpr


def _motion_scene():
    b = SceneBuilder()
    m = b.matte(kd=(0.8, 0.8, 0.8))
    pid = b.sphere(np.asarray(geom.translate([-1.0, 0.0, 0.0])), 0.5, m)
    b.animate(pid, np.asarray(geom.translate([1.0, 0.0, 0.0])))
    b.distant_light(direction=(0.0, 0.0, 1.0), radiance=(3.0, 3.0, 3.0))
    return b.build(accelerator="none")


CASES = {
    "demo_pass": lambda: _pass_jaxpr(
        build_demo_scene(accelerator="none"), build_demo_camera(W, H)),
    "motion_pass": lambda: _pass_jaxpr(_motion_scene(),
                                       build_demo_camera(W, H)),
    "mesh_pass": lambda: _pass_jaxpr(*gallery.config3(W, H)[:2]),
    "camera_build": lambda: jax.make_jaxpr(
        lambda: build_demo_camera(W, H))().jaxpr,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_dot_general_is_highest(case):
    precisions = _dot_precisions(CASES[case]())
    assert precisions, "no matrix product traced"
    assert all(p == HIGHEST for p in precisions), sorted(set(map(str, precisions)))
