"""Golden-image regression tests over the BASELINE configs.

Renders models/gallery configs 1-4 at fixed seeds and compares against the
checked-in references in tests/goldens/ (generated by
``python tests/goldens/generate.py`` on the CPU backend).  These lock the
renderer's radiometry between rounds: any change to sampling, shading, MIS
weights, film or filters that shifts the image fails here.

Tolerances: renders are deterministic on a fixed backend, but goldens must
survive benign op-reordering (XLA version bumps, refactors) while failing
on real radiometric change — hence tight-but-not-bitwise bounds.

compat_go golden: the demo scene developed with compat_go=True reproduces
the reference's quirky WriteImage semantics (no weight normalization, no
gamma — pkg/pbrt/film.go:142-179) for a future pixel-diff against the Go
binary's PNG.
"""

import os

import numpy as np
import pytest

from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.gallery import (
    CONFIGS,
    golden_check,
    golden_config,
    render_compat_go_demo,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# per-config gates: gallery.GOLDEN_TOLS (shared with chip_smoke.py, which
# holds the same renders on the GPU to the same gates)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, name + ".npz")
    assert os.path.exists(path), (
        f"golden missing: run `python tests/goldens/generate.py` and commit"
    )
    ref = np.load(path)["img"].astype(np.float32)
    scene, cam, settings = golden_config(name)
    img = np.asarray(render_mod.render(scene, cam, settings))
    assert img.shape == ref.shape
    mean, within, ok = golden_check(name, img, ref)
    assert ok, f"mean drift {mean:.2e}, pixels within gate {within:.4f}"


def test_golden_compat_go_demo():
    """Demo film developed with the reference's WriteImage semantics."""
    path = os.path.join(GOLDEN_DIR, "compat_go_demo.npz")
    assert os.path.exists(path)
    ref = np.load(path)["img"].astype(np.float32)
    img = render_compat_go_demo()
    mean, within, ok = golden_check("compat_go_demo", img, ref)
    assert ok, f"mean drift {mean:.2e}, pixels within gate {within:.4f}"
