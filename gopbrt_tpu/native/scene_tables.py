"""Flat host tables of a scene's materials and lights, in the column layout
the scalar C++ tracer (``native/cpu_baseline.cpp``, ``GMat`` and the light
records) reads from the GOPBRT-SCENE-1 dump written by
``benchmarks/cross_validate.py``.
"""

from __future__ import annotations

import numpy as np

# material shade-table columns (mirrored by the MS_* enum in cpu_baseline.cpp)
MS_C1 = 0       # 0-2  kd constant / checker colour 1
MS_C2 = 3       # 3-5  checker colour 2
MS_CHK = 6      # is_checker flag
MS_VS = 7       # 7-9  planar mapping s axis
MS_VT = 10      # 10-12 planar mapping t axis
MS_DS = 13      # 13-14 mapping offsets
MS_TSS = 15     # |vs| (checker AA filter width)
MS_TST = 16     # |vt|
MS_MIR = 17     # mirror flag
MS_KS = 18      # 18-20 kr (mirror) / ks (plastic GGX) / kr (glass)
MS_GLS = 21     # smooth-glass flag
MS_KT = 22      # 22-24 glass transmittance
MS_ETA = 25     # dielectric IOR (glass interface / plastic fresnel)
MS_PLA = 26     # plastic flag
MS_ALPHA = 27   # GGX alpha (already remapped at build)
MS_K = 28


def mat_shade_table(scene) -> np.ndarray:
    """Per-material shade table f32[M, MS_K] (see the MS_* layout)."""
    mats = scene.materials
    tex = scene.textures
    nm = int(mats.mat_type.shape[0])
    out = np.zeros((nm, MS_K), np.float32)
    mt = np.asarray(mats.mat_type)
    kd = np.asarray(mats.kd)
    kdt = np.asarray(mats.kd_tex)
    kr = np.asarray(mats.kr)
    kt = np.asarray(mats.kt)
    eta = np.asarray(mats.eta)
    rough = np.asarray(mats.roughness)
    ttype = np.asarray(tex.tex_type)
    v1 = np.asarray(tex.value1)
    v2 = np.asarray(tex.value2)
    vs = np.asarray(tex.vs)
    vt = np.asarray(tex.vt)
    ds = np.asarray(tex.dsdt)
    for i in range(nm):
        spec = mt[i] in (1, 2)  # MIRROR / GLASS: no diffuse lobe
        c1 = np.zeros(3) if spec else kd[i]
        c2 = c1
        chk = 0.0
        mvs = np.zeros(3)
        mvt = np.zeros(3)
        mds = np.zeros(2)
        t = int(kdt[i])
        if t >= 0 and not spec:
            if ttype[t] == 0:  # TEX_CONSTANT
                c1 = v1[t]
                c2 = c1
            else:  # TEX_CHECKERBOARD (planar mapping)
                c1 = v1[t]
                c2 = v2[t]
                chk = 1.0
                mvs = vs[t]
                mvt = vt[t]
                mds = ds[t]
        out[i, MS_C1:MS_C1 + 3] = c1
        out[i, MS_C2:MS_C2 + 3] = c2
        out[i, MS_CHK] = chk
        out[i, MS_VS:MS_VS + 3] = mvs
        out[i, MS_VT:MS_VT + 3] = mvt
        out[i, MS_DS:MS_DS + 2] = mds
        out[i, MS_TSS] = float(np.linalg.norm(mvs))
        out[i, MS_TST] = float(np.linalg.norm(mvt))
        out[i, MS_MIR] = 1.0 if mt[i] == 1 else 0.0
        out[i, MS_KS:MS_KS + 3] = kr[i]
        out[i, MS_GLS] = 1.0 if mt[i] == 2 else 0.0
        out[i, MS_KT:MS_KT + 3] = kt[i]
        out[i, MS_ETA] = eta[i]
        out[i, MS_PLA] = 1.0 if mt[i] == 3 else 0.0
        out[i, MS_ALPHA] = max(float(rough[i]), 1e-3)
    return out


def light_tables(scene):
    """(ltype i32[L], lpos f32[L,3], lint f32[L,3], laux f32[L,8]).

    laux columns: two_sided, world centre (3), world radius of a sphere
    emitter, the light's selection weight, 2 zero pad.
    """
    lights = scene.lights
    o2w = np.asarray(lights.o2w)
    center = o2w[:, :3, 3]
    scale = np.sqrt(np.sum(o2w[:, :3, 0] * o2w[:, :3, 0], axis=-1))
    radius_w = np.asarray(lights.params)[:, 0] * scale
    laux = np.concatenate(
        [
            np.asarray(lights.two_sided, np.float32)[:, None],
            center,
            radius_w[:, None],
            np.asarray(scene.light_func)[:, None],
            np.zeros((lights.count, 2), np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    return (np.asarray(lights.light_type), np.asarray(lights.p),
            np.asarray(lights.intensity), laux)
