"""What every entry point shares: the compile-cache helper, chip_smoke's
refusal to run without a GPU, and the scene tables the C++ cross-check
tracer reads."""

from pathlib import Path

import jax
import numpy as np
import pytest

from gopbrt_tpu import compile_cache
from gopbrt_tpu.models import gallery
from gopbrt_tpu.native import scene_tables as st

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_env_set_sets_nothing(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "/unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/unchanged"


@pytest.mark.parametrize("cwd", ["repo", "elsewhere"])
def test_cache_env_unset_uses_checkout(monkeypatch, tmp_path, cwd,
                                       restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(ROOT if cwd == "repo" else tmp_path)
    got = compile_cache.enable_compile_cache()
    # found from the package, never from the working directory
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


# ---------------------------------------------------------------------------
# chip_smoke.py refuses the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_require_gpu_refuses_cpu(chip_smoke):
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_main_prints_no_result_on_cpu(chip_smoke, capsys, argv,
                                                 restore_cache_dir):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    for line in capsys.readouterr().out.splitlines():
        assert not line.startswith("{"), line
        assert "--- phase" not in line  # no phase started


# ---------------------------------------------------------------------------
# native/scene_tables: the C++ tracer's material and light records
# ---------------------------------------------------------------------------


def test_mat_shade_table_config4():
    scene = gallery.config4()[0]
    tab = st.mat_shade_table(scene)
    mt = np.asarray(scene.materials.mat_type)
    assert tab.shape == (len(mt), st.MS_K)
    floor, glass, matte = 0, 1, 2  # config4's builder order
    # the checkered floor: both colours, its planar axes and their lengths
    tex = scene.textures
    t = int(scene.materials.kd_tex[floor])
    assert tab[floor, st.MS_CHK] == 1.0
    np.testing.assert_allclose(tab[floor, st.MS_C1:st.MS_C1 + 3], tex.value1[t])
    np.testing.assert_allclose(tab[floor, st.MS_C2:st.MS_C2 + 3], tex.value2[t])
    np.testing.assert_allclose(tab[floor, st.MS_TSS], 0.7, rtol=1e-6)
    # smooth glass: no diffuse colour, its transmittance and IOR
    assert tab[glass, st.MS_GLS] == 1.0 and tab[glass, st.MS_MIR] == 0.0
    np.testing.assert_array_equal(tab[glass, st.MS_C1:st.MS_C1 + 6], 0.0)
    np.testing.assert_allclose(tab[glass, st.MS_KT:st.MS_KT + 3], 1.0)
    assert tab[glass, st.MS_ETA] == pytest.approx(1.5)
    # plain matte: its kd, no flags
    np.testing.assert_allclose(tab[matte, st.MS_C1:st.MS_C1 + 3],
                               [0.7, 0.3, 0.2], rtol=1e-6)
    assert tab[matte, [st.MS_CHK, st.MS_MIR, st.MS_GLS, st.MS_PLA]].sum() == 0
    assert (tab[:, st.MS_ALPHA] >= 1e-3).all()


def test_light_tables_config2():
    scene = gallery.config2()[0]
    ltype, lpos, lint, laux = st.light_tables(scene)
    assert ltype.shape == (1,) and laux.shape == (1, 8)
    assert laux.dtype == np.float32
    np.testing.assert_allclose(lint[0], 22.0)
    assert laux[0, 0] == 0.0  # one-sided lamp
    np.testing.assert_allclose(laux[0, 1:4], [0.0, 3.6, 0.0], atol=1e-6)
    assert laux[0, 4] == pytest.approx(0.35)  # world radius
    np.testing.assert_array_equal(laux[0, 6:], 0.0)
