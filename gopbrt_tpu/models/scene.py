"""Scene construction: a host-side builder producing device SoA tables.

Replaces the reference's object-graph scene assembly — []Primitive of
GeometricPrimitive/TransformedPrimitive + []Light handed to NewScene
(``internal/render/server.go:30-132``, ``pkg/pbrt/scene.go:16-36``) — with a
Python builder that compiles to a flat, jit-friendly pytree of arrays.
Interface dispatch becomes integer tags; the "plugin architecture" becomes a
closed set of table rows.

The builder runs in NumPy on the host (scene build = the reference's
server-side setup, not a hot path); ``build()`` uploads once to device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from gopbrt_tpu.ops import geom, sampling
from gopbrt_tpu.ops.intersect import Primitives, SPHERE, DISK, TRIANGLE
from gopbrt_tpu.ops.lights import (
    Lights,
    LIGHT_POINT,
    LIGHT_DISTANT,
    LIGHT_AREA,
    SHAPE_SPHERE,
    SHAPE_DISK,
)
from gopbrt_tpu.ops.texture import (
    Textures,
    TEX_CONSTANT,
    TEX_CHECKERBOARD,
    TEX_UV,
    TEX_IMAGE,
    MAP_UV,
    MAP_PLANAR,
)
from gopbrt_tpu.ops.bsdf import (
    MATTE, MIRROR, GLASS, PLASTIC, METAL, SUBSURFACE, NULLMAT,
)


class Materials(NamedTuple):
    """SoA material table (closed set — see ops/bsdf.py)."""

    mat_type: jnp.ndarray  # int32[M]
    kd: jnp.ndarray  # f32[M,3]
    kd_tex: jnp.ndarray  # int32[M]  texture id, -1 = constant kd
    sigma: jnp.ndarray  # f32[M]
    kr: jnp.ndarray  # f32[M,3]
    kt: jnp.ndarray  # f32[M,3]
    eta: jnp.ndarray  # f32[M]
    roughness: jnp.ndarray  # f32[M] GGX alpha (pre-remapped at build)
    # bump mapping (Material.Bump — a discarded stub in the reference,
    # material.go:18-34; implemented here): float texture perturbing the
    # shading normal.  None when no material uses bump (skips the cost).
    bump_tex: Optional[jnp.ndarray] = None  # int32[M], -1 = none
    bump_scale: Optional[jnp.ndarray] = None  # f32[M]
    # subsurface scattering (Burley separable BSSRDF, ops/bssrdf.py —
    # the working version of the reference's dead BSSRDF hook,
    # bssrdf.go:3-12 / path.go:120-141): per-channel diffusion radius
    # d = mfp / s(ρ).  None when no material is subsurface — the probe
    # transport then compiles out of the integrator entirely.
    sss_d: Optional[jnp.ndarray] = None  # f32[M,3]
    # precomputed Sw normalization c-bar per material (ADVICE r1 #2)
    sss_cbar: Optional[jnp.ndarray] = None  # f32[M]
    # static lobe-set descriptor (ops/static_info.MatInfo); None = all lobes
    info: "object" = None


class LightGrid(NamedTuple):
    """Spatial light-sampling distribution (the reference's unimplemented
    LightStrategy Spatial, lightdistribution.go:11-19): a voxel grid over
    the scene bounds with a per-voxel Distribution1D over lights, estimated
    at build time from distance-attenuated light power."""

    lo: jnp.ndarray  # f32[3] grid origin
    inv_extent: jnp.ndarray  # f32[3] 1 / world extent
    dims: jnp.ndarray  # int32[3] grid resolution
    func: jnp.ndarray  # f32[V, L]
    cdf: jnp.ndarray  # f32[V, L+1]
    func_int: jnp.ndarray  # f32[V]


class Scene(NamedTuple):
    """The whole scene as one pytree — everything jit-traceable.

    light_power/cdf: Distribution1D over lights (lightdistribution.go,
    with Uniform and Power strategies both expressible; Spatial TODO).
    """

    prims: Primitives
    materials: Materials
    textures: Textures
    lights: Lights
    light_func: jnp.ndarray
    light_cdf: jnp.ndarray
    light_func_int: jnp.ndarray
    world_center: jnp.ndarray  # f32[3]
    world_radius: jnp.ndarray  # f32[]
    bvh: Optional["object"] = None  # ops.bvh.LinearBVH, attached by build()
    light_grid: Optional[LightGrid] = None  # spatial strategy only
    # global participating medium (the "camera medium"): when set, the path
    # integrator runs full volumetric transport — distance-sampled HG
    # in-scatter vertices + Beer-Lambert Tr on every NEE shadow ray (the
    # working version of Scene.IntersectTr / VisibilityTester.Tr,
    # scene.go:58-77 / light.go:50-73, which the reference plumbs but can
    # never exercise: it ships no concrete Medium).  None compiles all
    # medium code out of the integrator.
    medium: Optional["object"] = None  # ops.media.HomogeneousMedium
    # per-primitive medium system (ops/media.MediaTable + the
    # medium_inside/outside columns on Primitives): bounded media regions
    # with null-material boundaries — the working MediumInterface
    # (medium.go:15-25) + nil-material passthrough (path.go:72-78) +
    # boundary-walking transmittance (Scene.IntersectTr, scene.go:58-77).
    # None = no bounded media (the global ``medium`` above may still be set).
    media: Optional["object"] = None
    # index into ``media`` of the medium containing the camera; -1 = vacuum
    camera_medium: int = -1

    @property
    def n_lights(self) -> int:
        return self.lights.count


@dataclass
class SceneBuilder:
    """Accumulates primitives / materials / textures / lights, then builds.

    API shape mirrors the construction calls in internal/render/server.go
    (NewSphereShape + NewMatteMaterial + NewGeometricPrimitive + ...), but
    produces SoA tables instead of an object graph.
    """

    light_strategy: str = "uniform"  # or "power" (lightdistribution.go:3-9)

    _medium: Optional[tuple] = None  # (sigma_a, sigma_s, g)
    _media: list = field(default_factory=list)  # bounded media rows
    _camera_medium: int = -1
    _medium_iface: dict = field(default_factory=dict)  # prim -> (in, out)

    _prim_type: list = field(default_factory=list)
    _o2w: list = field(default_factory=list)
    _params: list = field(default_factory=list)
    _mat_id: list = field(default_factory=list)
    _area_light: list = field(default_factory=list)
    _reverse: list = field(default_factory=list)

    _o2w_end: dict = field(default_factory=dict)  # prim_id -> end keyframe

    _materials: list = field(default_factory=list)
    _textures: list = field(default_factory=list)
    _atlas_images: list = field(default_factory=list)
    _lights: list = field(default_factory=list)

    # --- textures ---------------------------------------------------------

    def _add_texture(self, row) -> int:
        self._textures.append(row)
        return len(self._textures) - 1

    def constant_texture(self, rgb) -> int:
        return self._add_texture(
            dict(type=TEX_CONSTANT, v1=_rgb(rgb), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(1, 0, 0), vt=(0, 1, 0), dsdt=(0, 0), image=None)
        )

    def checkerboard_texture(
        self, tex1_rgb, tex2_rgb, vs=(1.0, 0, 0), vt=(0, 1.0, 0), ds=0.0, dt=0.0,
        mapping: str = "planar",
    ) -> int:
        """Checkerboard of two constant colours (checkerboard.go:15-40) with
        planar or uv mapping (texture.go:29-46)."""
        return self._add_texture(
            dict(
                type=TEX_CHECKERBOARD,
                v1=_rgb(tex1_rgb),
                v2=_rgb(tex2_rgb),
                mapping=MAP_PLANAR if mapping == "planar" else MAP_UV,
                vs=tuple(vs),
                vt=tuple(vt),
                dsdt=(ds, dt),
                image=None,
            )
        )

    def uv_texture(self) -> int:
        return self._add_texture(
            dict(type=TEX_UV, v1=(0, 0, 0), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(1, 0, 0), vt=(0, 1, 0), dsdt=(0, 0), image=None)
        )

    def image_texture(self, image: np.ndarray, su=1.0, sv=1.0) -> int:
        """Image texture from an [H,W,3] float array (parity extra)."""
        img = np.asarray(image, np.float32)
        assert img.ndim == 3 and img.shape[-1] == 3
        return self._add_texture(
            dict(type=TEX_IMAGE, v1=(0, 0, 0), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(su, 0, 0), vt=(0, sv, 0), dsdt=(0, 0), image=img)
        )

    # --- materials --------------------------------------------------------

    def _add_material(self, **kw) -> int:
        row = dict(
            mat_type=MATTE, kd=(0.5, 0.5, 0.5), kd_tex=-1, sigma=0.0,
            kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5, roughness=0.0,
            bump_tex=-1, bump_scale=1.0, sss_d=(0.0, 0.0, 0.0),
        )
        row.update(kw)
        self._materials.append(row)
        return len(self._materials) - 1

    def matte(self, kd=(0.5, 0.5, 0.5), kd_tex: int = -1, sigma: float = 0.0,
              bump_tex: int = -1, bump_scale: float = 1.0) -> int:
        """Matte: Lambertian (sigma=0) or Oren–Nayar (matte.go:21-37)."""
        return self._add_material(
            mat_type=MATTE, kd=_rgb(kd), kd_tex=kd_tex, sigma=sigma,
            bump_tex=bump_tex, bump_scale=bump_scale,
        )

    def mirror(self, kr=(0.9, 0.9, 0.9)) -> int:
        """Perfect mirror (mirror.go:21-32)."""
        return self._add_material(mat_type=MIRROR, kr=_rgb(kr))

    def glass(self, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5, roughness=0.0,
              remap_roughness=True) -> int:
        """Glass (glass.go:27-75): smooth -> FresnelSpecular, rough -> GGX."""
        alpha = _remap(roughness) if (remap_roughness and roughness > 0) else roughness
        return self._add_material(
            mat_type=GLASS, kr=_rgb(kr), kt=_rgb(kt), eta=eta, roughness=alpha
        )

    def plastic(self, kd=(0.5, 0.5, 0.5), kd_tex=-1, ks=(0.25, 0.25, 0.25),
                roughness=0.1, remap_roughness=True) -> int:
        alpha = _remap(roughness) if remap_roughness else roughness
        return self._add_material(
            mat_type=PLASTIC, kd=_rgb(kd), kd_tex=kd_tex, kr=_rgb(ks),
            eta=1.5, roughness=max(alpha, 1e-3),
        )

    def metal(self, f0=(0.9, 0.6, 0.3), roughness=0.05, remap_roughness=True) -> int:
        alpha = _remap(roughness) if remap_roughness else roughness
        return self._add_material(
            mat_type=METAL, kr=_rgb(f0), roughness=max(alpha, 1e-3)
        )

    def subsurface(self, rho=(0.8, 0.5, 0.3), mfp=(0.2, 0.2, 0.2), eta=1.33) -> int:
        """Subsurface-scattering material: Burley separable BSSRDF with
        diffuse albedo rho, per-channel mean free path mfp (world units),
        and interface IOR eta.  The reference declares BSSRDF but never
        implements or wires it (bssrdf.go:3-12, path.go:120-141); here the
        full probe-ray transport runs (ops/bssrdf.py)."""
        from gopbrt_tpu.ops.bssrdf import burley_scaling

        rho_t = _rgb(rho)
        mfp_t = _rgb(mfp)
        d = tuple(
            max(m, 1e-5) / float(burley_scaling(a))
            for a, m in zip(rho_t, mfp_t)
        )
        return self._add_material(
            mat_type=SUBSURFACE, kd=rho_t, eta=eta, sss_d=d
        )

    # --- primitives -------------------------------------------------------

    def _add_prim(self, ptype, o2w, params, mat_id, reverse=False) -> int:
        self._prim_type.append(ptype)
        self._o2w.append(np.asarray(o2w, np.float32))
        p = np.zeros(9, np.float32)
        p[: len(params)] = params
        self._params.append(p)
        self._mat_id.append(mat_id)
        self._area_light.append(-1)
        self._reverse.append(bool(reverse))
        return len(self._prim_type) - 1

    def sphere(self, o2w, radius, material: int, z_min=None, z_max=None,
               phi_max_deg=360.0, reverse_orientation=False) -> int:
        """Sphere primitive (pbrt.NewSphereShape, sphere.go:189-228)."""
        z_min = -radius if z_min is None else z_min
        z_max = radius if z_max is None else z_max
        return self._add_prim(
            SPHERE, o2w,
            [radius, z_min, z_max, math.radians(phi_max_deg)],
            material, reverse_orientation,
        )

    def disk(self, o2w, radius, material: int, height=0.0, inner_radius=0.0,
             phi_max_deg=360.0, reverse_orientation=False) -> int:
        """Disk primitive (shapes.NewDisk, disk.go:17-40)."""
        return self._add_prim(
            DISK, o2w,
            [height, radius, inner_radius, math.radians(phi_max_deg)],
            material, reverse_orientation,
        )

    def triangle(self, p0, p1, p2, material: int, reverse_orientation=False) -> int:
        """Single world-space triangle (PBRT parity; reference has none)."""
        return self._add_prim(
            TRIANGLE, np.eye(4, dtype=np.float32),
            list(p0) + list(p1) + list(p2), material, reverse_orientation,
        )

    def triangle_mesh(self, o2w, vertices, indices, material: int,
                      reverse_orientation=False) -> list[int]:
        """Triangle mesh: vertices pre-transformed to world space at build
        (object instancing for meshes trades memory for a transform-free
        hot path; the mesh lives in device memory once).
        """
        verts = np.asarray(vertices, np.float32)
        m = np.asarray(o2w, np.float32)
        verts = verts @ m[:3, :3].T + m[:3, 3]
        ids = []
        for (a, b, c) in np.asarray(indices, np.int64).reshape(-1, 3):
            ids.append(
                self.triangle(verts[a], verts[b], verts[c], material,
                              reverse_orientation)
            )
        return ids

    def animate(self, prim_id: int, o2w_end) -> None:
        """Two-keyframe motion: the primitive moves from its build transform
        to ``o2w_end`` across the camera shutter ([0,1] ray time) — the
        working TransformedPrimitive + AnimatedTransform
        (``pkg/pbrt/primitive.go:82-129``; the reference's decompose is a
        TODO so any real animation nil-derefs, quirk #9).  Camera rays get
        per-sample times (render.camera_time) and every intersection
        interpolates this primitive's transform at the lane's time."""
        assert self._prim_type[prim_id] in (SPHERE, DISK), (
            "animated triangles not supported (world-space vertices)"
        )
        self._o2w_end[prim_id] = np.asarray(o2w_end, np.float32)

    # --- media ------------------------------------------------------------

    def set_medium(self, sigma_a, sigma_s=(0.0, 0.0, 0.0), g: float = 0.0):
        """Attach a global homogeneous medium (fog) filling the scene.

        The reference declares Medium{Tr, Sample} (medium.go:5-25) and the
        transmittance plumbing (scene.go:58-77, light.go:50-73) but ships no
        concrete medium; this is the working equivalent: Beer-Lambert
        absorption+out-scatter on every path and shadow segment, and HG
        in-scattering vertices when sigma_s > 0."""
        self._medium = (_rgb(sigma_a), _rgb(sigma_s), float(g))

    def add_medium(self, sigma_a, sigma_s=(0.0, 0.0, 0.0), g: float = 0.0) -> int:
        """Register a BOUNDED homogeneous medium and return its id for
        ``medium_interface=`` on primitives / ``set_camera_medium`` —
        the working MediumInterface system (medium.go:15-25): rays track
        their current medium per lane and switch it when they cross a
        boundary (null-material passthrough, path.go:72-78, or specular
        transmission)."""
        self._media.append((_rgb(sigma_a), _rgb(sigma_s), float(g)))
        return len(self._media) - 1

    def set_camera_medium(self, medium_id: int) -> None:
        """Declare the medium containing the camera (-1 = vacuum)."""
        self._camera_medium = int(medium_id)

    def set_medium_interface(self, prim_id: int, inside: int,
                             outside: int = -1) -> None:
        """Attach a medium interface to a primitive: ``inside`` fills its
        interior, ``outside`` its exterior (-1 = vacuum).  Pair with a
        ``null_material`` primitive for a pure medium boundary, or with
        glass for a filled shell."""
        self._medium_iface[prim_id] = (int(inside), int(outside))

    def null_material(self) -> int:
        """Material-less boundary (the reference's nil material,
        path.go:72-78): rays pass through without scattering or consuming
        a bounce; only the medium interface acts."""
        return self._add_material(mat_type=NULLMAT, kd=(0.0, 0.0, 0.0))

    # --- lights -----------------------------------------------------------

    def point_light(self, p, intensity) -> int:
        """Point light (lights.NewPoint, point.go:19-42)."""
        self._lights.append(
            dict(type=LIGHT_POINT, p=_rgb(p), intensity=_rgb(intensity),
                 two_sided=False, prim=-1, shape=SHAPE_SPHERE,
                 o2w=np.eye(4, dtype=np.float32), params=np.zeros(9, np.float32))
        )
        return len(self._lights) - 1

    def distant_light(self, direction, radiance) -> int:
        """Distant light; direction points *toward* the light, matching the
        demo's usage (server.go:108-112 passes w={-1,1,1} and distant.go:40-44
        returns wi=normalize(w))."""
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        self._lights.append(
            dict(type=LIGHT_DISTANT, p=tuple(d), intensity=_rgb(radiance),
                 two_sided=False, prim=-1, shape=SHAPE_SPHERE,
                 o2w=np.eye(4, dtype=np.float32), params=np.zeros(9, np.float32))
        )
        return len(self._lights) - 1

    def area_light(self, prim_id: int, radiance, two_sided=False) -> int:
        """Attach diffuse-area emission to an existing sphere/disk primitive
        (lights.NewDiffuseAreaLight + the GeometricPrimitive.areaLight slot,
        diffuse.go:12-34, primitive.go:24-44)."""
        ptype = self._prim_type[prim_id]
        assert ptype in (SPHERE, DISK), "area lights need sphere/disk shapes"
        shape = SHAPE_SPHERE if ptype == SPHERE else SHAPE_DISK
        o2w = self._o2w[prim_id]
        self._lights.append(
            dict(type=LIGHT_AREA, p=tuple(o2w[:3, 3]), intensity=_rgb(radiance),
                 two_sided=bool(two_sided), prim=prim_id, shape=shape,
                 o2w=o2w, params=self._params[prim_id])
        )
        lid = len(self._lights) - 1
        self._area_light[prim_id] = lid
        return lid

    # --- world bounds (host) ---------------------------------------------

    def _prim_world_bounds(self, i) -> tuple[np.ndarray, np.ndarray]:
        if i in self._o2w_end:
            # animated: conservative union of bounds over sampled shutter
            # times (AnimatedTransform MotionBounds role)
            from gopbrt_tpu.ops import quaternion as quat

            at = quat.animated_transform(self._o2w[i], self._o2w_end[i])
            los, his = [], []
            for t in np.linspace(0.0, 1.0, 9):
                m_t = np.asarray(quat.interpolate(at, t))
                lo, hi = self._prim_world_bounds_static(i, m_t)
                los.append(lo)
                his.append(hi)
            pad = 0.05 * (np.max(his, axis=0) - np.min(los, axis=0))
            return np.min(los, axis=0) - pad, np.max(his, axis=0) + pad
        return self._prim_world_bounds_static(i, self._o2w[i])

    def _prim_world_bounds_static(self, i, m) -> tuple[np.ndarray, np.ndarray]:
        pt = self._prim_type[i]
        pr = self._params[i]
        if pt == SPHERE:
            r = pr[0]
            lo, hi = np.array([-r, -r, pr[1]]), np.array([r, r, pr[2]])
        elif pt == DISK:
            r = pr[1]
            lo, hi = np.array([-r, -r, pr[0] - 1e-3]), np.array([r, r, pr[0] + 1e-3])
        else:
            v = pr.reshape(3, 3)
            return v.min(axis=0), v.max(axis=0)
        corners = np.array(
            [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]],
             [hi[0], hi[1], lo[2]], [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
             [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]]
        )
        tc = corners @ m[:3, :3].T + m[:3, 3]
        return tc.min(axis=0), tc.max(axis=0)

    def world_bounds(self):
        los, his = zip(*[self._prim_world_bounds(i) for i in range(len(self._prim_type))])
        return np.min(los, axis=0), np.max(his, axis=0)

    # --- build ------------------------------------------------------------

    def build(self, accelerator: str = "bvh") -> Scene:
        n = len(self._prim_type)
        assert n > 0, "empty scene"
        if not self._materials:
            self.matte()
        if not self._textures:
            self.constant_texture((0.0, 0.0, 0.0))
        from gopbrt_tpu.ops.static_info import MatInfo, PrimInfo

        o2w = np.stack(self._o2w)
        w2o = np.linalg.inv(o2w.astype(np.float64)).astype(np.float32)

        # static shape-set facts (compile out unused intersect kernels)
        ptypes_np = np.asarray(self._prim_type, np.int32)
        params_np = np.stack(self._params)
        two_pi = 2.0 * math.pi - 1e-6
        sph = params_np[ptypes_np == SPHERE]
        dsk = params_np[ptypes_np == DISK]
        pinfo = PrimInfo(
            types=tuple(sorted(set(int(t) for t in ptypes_np))),
            all_full_spheres=bool(
                sph.size == 0
                or np.all(
                    (sph[:, 1] <= -sph[:, 0]) & (sph[:, 2] >= sph[:, 0])
                    & (sph[:, 3] >= two_pi)
                )
            ),
            all_full_disks=bool(
                dsk.size == 0
                or np.all((dsk[:, 2] <= 0.0) & (dsk[:, 3] >= two_pi))
            ),
        )
        anim = None
        if self._o2w_end:
            # two-keyframe animation table: decomposed T/R/S per prim
            # (quaternion.decompose — the reference's transform.go:537-539
            # TODO, implemented); static prims carry identical keyframes
            from gopbrt_tpu.ops import quaternion as quat
            from gopbrt_tpu.ops.intersect import AnimPrims

            end = np.stack(
                [self._o2w_end.get(i, o2w[i]) for i in range(n)]
            ).astype(np.float32)
            t0_, q0_, s0_ = quat.decompose(jnp.asarray(o2w))
            t1_, q1_, s1_ = quat.decompose(jnp.asarray(end))
            q1_ = jnp.where(
                (jnp.sum(q0_ * q1_, axis=-1) < 0.0)[:, None], -q1_, q1_
            )
            animated = jnp.asarray(
                np.any(np.abs(end - o2w) > 1e-7, axis=(1, 2))
            )
            anim = AnimPrims(
                t0=t0_, t1=t1_, q0=q0_, q1=q1_, s0=s0_, s1=s1_,
                animated=animated,
            )
        med_in = med_out = None
        if self._medium_iface:
            # -2 = "no transition" sentinel (a primitive without a declared
            # interface leaves the ray's medium unchanged when crossed)
            mi = np.full((n,), -2, np.int32)
            mo = np.full((n,), -2, np.int32)
            for pid, (i_in, i_out) in self._medium_iface.items():
                mi[pid] = i_in
                mo[pid] = i_out
            med_in, med_out = jnp.asarray(mi), jnp.asarray(mo)
        prims = Primitives(
            prim_type=jnp.asarray(ptypes_np),
            obj_to_world=jnp.asarray(o2w),
            world_to_obj=jnp.asarray(w2o),
            params=jnp.asarray(params_np),
            material_id=jnp.asarray(np.asarray(self._mat_id, np.int32)),
            area_light_id=jnp.asarray(np.asarray(self._area_light, np.int32)),
            reverse_orientation=jnp.asarray(np.asarray(self._reverse, bool)),
            pinfo=pinfo,
            anim=anim,
            medium_inside=med_in,
            medium_outside=med_out,
        )

        # static lobe-set facts (compile out unused BSDF lobes)
        glass_alphas = [
            m["roughness"] for m in self._materials if m["mat_type"] == GLASS
        ]
        mat_types = set(m["mat_type"] for m in self._materials)
        if SUBSURFACE in mat_types:
            # the BSSRDF entry interface turns Fresnel-reflect lanes into
            # unit mirrors (integrators._subsurface_transport)
            mat_types.add(MIRROR)
        if self._medium is not None or self._media:
            # medium in-scatter vertices ride the wavefront as neutralized
            # MATTE lanes (integrators._bounce_once splice)
            mat_types.add(MATTE)
        minfo = MatInfo(
            mat_types=tuple(sorted(mat_types)),
            any_rough_glass=any(a > 1e-4 for a in glass_alphas),
            any_smooth_glass=any(a <= 1e-4 for a in glass_alphas),
            any_oren_nayar=any(
                m["mat_type"] == MATTE and m["sigma"] > 0.0
                for m in self._materials
            ),
        )
        has_sss = any(m["mat_type"] == SUBSURFACE for m in self._materials)
        mats = Materials(
            mat_type=jnp.asarray([m["mat_type"] for m in self._materials], jnp.int32),
            kd=jnp.asarray([m["kd"] for m in self._materials], jnp.float32),
            kd_tex=jnp.asarray([m["kd_tex"] for m in self._materials], jnp.int32),
            sigma=jnp.asarray([m["sigma"] for m in self._materials], jnp.float32),
            kr=jnp.asarray([m["kr"] for m in self._materials], jnp.float32),
            kt=jnp.asarray([m["kt"] for m in self._materials], jnp.float32),
            eta=jnp.asarray([m["eta"] for m in self._materials], jnp.float32),
            roughness=jnp.asarray(
                [m["roughness"] for m in self._materials], jnp.float32
            ),
            bump_tex=(
                jnp.asarray([m["bump_tex"] for m in self._materials], jnp.int32)
                if any(m["bump_tex"] >= 0 for m in self._materials)
                else None
            ),
            bump_scale=(
                jnp.asarray([m["bump_scale"] for m in self._materials], jnp.float32)
                if any(m["bump_tex"] >= 0 for m in self._materials)
                else None
            ),
            sss_d=(
                jnp.asarray([m["sss_d"] for m in self._materials], jnp.float32)
                if has_sss
                else None
            ),
            sss_cbar=(
                _sss_cbar_table([m["eta"] for m in self._materials])
                if has_sss
                else None
            ),
            info=minfo,
        )
        texs = self._build_textures()
        lights = self._build_lights()
        lo, hi = self.world_bounds()
        center = 0.5 * (lo + hi)
        radius = float(np.linalg.norm(hi - center))

        lf, lcdf, lint = self._light_distribution(lights, radius)
        light_grid = None
        if self.light_strategy == "spatial" and self._lights:
            light_grid = self._build_light_grid(lo, hi)
        medium = None
        if self._medium is not None:
            from gopbrt_tpu.ops.media import HomogeneousMedium

            sa, ss, g = self._medium
            medium = HomogeneousMedium(
                sigma_a=jnp.asarray(sa, jnp.float32),
                sigma_s=jnp.asarray(ss, jnp.float32),
                g=jnp.asarray(g, jnp.float32),
            )
        media = None
        if self._media:
            from gopbrt_tpu.ops.media import MediaTable

            assert self._medium is None, (
                "bounded media (add_medium) and the global medium "
                "(set_medium) are mutually exclusive"
            )
            media = MediaTable(
                sigma_a=jnp.asarray([m[0] for m in self._media], jnp.float32),
                sigma_s=jnp.asarray([m[1] for m in self._media], jnp.float32),
                g=jnp.asarray([m[2] for m in self._media], jnp.float32),
            )
        scene = Scene(
            prims=prims,
            materials=mats,
            textures=texs,
            lights=lights,
            light_func=lf,
            light_cdf=lcdf,
            light_func_int=lint,
            world_center=jnp.asarray(center, jnp.float32),
            world_radius=jnp.asarray(radius, jnp.float32),
            bvh=None,
            light_grid=light_grid,
            medium=medium,
            media=media,
            camera_medium=self._camera_medium,
        )
        if accelerator == "bvh" and n > 4:
            from gopbrt_tpu.ops import bvh as bvh_mod

            bvh = bvh_mod.build_bvh_host(self)
            scene = scene._replace(bvh=bvh)
        return scene

    def _build_textures(self) -> Textures:
        rows = self._textures
        t = len(rows)
        # pack image atlas (stack vertically)
        images = [r["image"] for r in rows if r["image"] is not None]
        if images:
            w = max(im.shape[1] for im in images)
            h = sum(im.shape[0] for im in images)
            atlas = np.zeros((h, w, 3), np.float32)
            rects = {}
            y = 0
            for r in rows:
                if r["image"] is not None:
                    im = r["image"]
                    atlas[y : y + im.shape[0], : im.shape[1]] = im
                    rects[id(r)] = (y, 0, im.shape[0], im.shape[1])
                    y += im.shape[0]
        else:
            atlas = np.zeros((1, 1, 3), np.float32)
            rects = {}
        rect_rows = [
            rects.get(id(r), (0, 0, 1, 1)) for r in rows
        ]
        return Textures(
            tex_type=jnp.asarray([r["type"] for r in rows], jnp.int32),
            value1=jnp.asarray([r["v1"] for r in rows], jnp.float32),
            value2=jnp.asarray([r["v2"] for r in rows], jnp.float32),
            mapping=jnp.asarray([r["mapping"] for r in rows], jnp.int32),
            vs=jnp.asarray([r["vs"] for r in rows], jnp.float32),
            vt=jnp.asarray([r["vt"] for r in rows], jnp.float32),
            dsdt=jnp.asarray([r["dsdt"] for r in rows], jnp.float32),
            atlas=jnp.asarray(atlas),
            image_rect=jnp.asarray(rect_rows, jnp.int32),
        )

    def _build_lights(self) -> Lights:
        rows = self._lights
        if not rows:
            # keep one dummy dark point light so table shapes are static
            rows = [dict(type=LIGHT_POINT, p=(0, 0, 0), intensity=(0, 0, 0),
                         two_sided=False, prim=-1, shape=SHAPE_SPHERE,
                         o2w=np.eye(4, dtype=np.float32), params=np.zeros(9, np.float32))]
        o2w = np.stack([r["o2w"] for r in rows])
        w2o = np.linalg.inv(o2w.astype(np.float64)).astype(np.float32)
        return Lights(
            light_type=jnp.asarray([r["type"] for r in rows], jnp.int32),
            p=jnp.asarray([r["p"] for r in rows], jnp.float32),
            intensity=jnp.asarray([r["intensity"] for r in rows], jnp.float32),
            two_sided=jnp.asarray([r["two_sided"] for r in rows], bool),
            prim_idx=jnp.asarray([r["prim"] for r in rows], jnp.int32),
            shape_kind=jnp.asarray([r["shape"] for r in rows], jnp.int32),
            o2w=jnp.asarray(o2w),
            w2o=jnp.asarray(w2o),
            params=jnp.asarray(np.stack([r["params"] for r in rows])),
        )

    def _light_distribution(self, lights: Lights, world_radius: float):
        from gopbrt_tpu.ops import lights as lights_ops

        if self.light_strategy == "power" and lights.count > 0:
            w = lights_ops.power(lights, world_radius)
        else:
            # "uniform" and the global fallback row for "spatial"
            w = jnp.ones((max(lights.count, 1),), jnp.float32)
        return sampling.distribution_1d(w)

    spatial_resolution: int = 8

    def _build_light_grid(self, wlo: np.ndarray, whi: np.ndarray) -> LightGrid:
        """Voxelised light importance (the Spatial strategy the reference
        left unimplemented).  Per voxel v and light l the weight is a
        deterministic estimate of the unoccluded contribution from the
        voxel center: lum(power_l) / max(d(v,l)^2, r_v^2); distant lights
        are distance-independent.  A floor of 0.1% of the voxel max keeps
        every light sampleable (unbiasedness)."""
        g = int(self.spatial_resolution)
        extent = np.maximum(whi - wlo, 1e-6)
        centers = np.stack(
            np.meshgrid(
                *(wlo[k] + (np.arange(g) + 0.5) / g * extent[k] for k in range(3)),
                indexing="ij",
            ),
            axis=-1,
        ).reshape(-1, 3)  # [V,3] with x fastest? ij -> dim order (x,y,z)
        n_l = len(self._lights)
        w = np.zeros((centers.shape[0], n_l), np.float32)
        r_v2 = float(np.sum((0.5 * extent / g) ** 2))
        for li, row in enumerate(self._lights):
            inten = float(np.mean(row["intensity"]))
            if row["type"] == LIGHT_DISTANT:
                w[:, li] = inten
                continue
            if row["type"] == LIGHT_AREA:
                # approximate emitter power: L * area (host-side)
                pr = row["params"]
                o2w = row["o2w"]
                scale = float(np.linalg.norm(o2w[:3, 0]))
                if row["shape"] == SHAPE_DISK:
                    area = pr[3] * 0.5 * (pr[1] ** 2 - pr[2] ** 2) * scale * scale
                else:
                    area = 4.0 * math.pi * (pr[0] * scale) ** 2
                inten = inten * float(area) * math.pi
            else:
                inten = inten * 4.0 * math.pi
            d2 = np.sum((centers - np.asarray(row["p"])) ** 2, axis=-1)
            w[:, li] = inten / np.maximum(d2, r_v2)
        # per-voxel floor so no light has zero probability anywhere
        w = np.maximum(w, 1e-3 * w.max(axis=-1, keepdims=True))
        func, cdf, func_int = sampling.distribution_1d(jnp.asarray(w))
        return LightGrid(
            lo=jnp.asarray(wlo, jnp.float32),
            inv_extent=jnp.asarray(1.0 / extent, jnp.float32),
            dims=jnp.asarray([g, g, g], jnp.int32),
            func=func,
            cdf=cdf,
            func_int=func_int,
        )


def _rgb(v) -> tuple:
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    v = tuple(float(x) for x in v)
    assert len(v) == 3
    return v


def _sss_cbar_table(etas) -> jnp.ndarray:
    """Per-material Sw normalization c-bar = sw_normalization(eta), computed
    once at build (ADVICE r1 #2: the 64-point Fresnel quadrature must not
    run per lane per bounce)."""
    from gopbrt_tpu.ops.bssrdf import sw_normalization

    return sw_normalization(jnp.asarray(etas, jnp.float32))


def _remap(roughness: float) -> float:
    """Host-side RoughnessToAlpha (microfacet.go:186-190)."""
    x = math.log(max(roughness, 1e-3))
    return (
        1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x**3
        + 0.000640711 * x**4
    )
