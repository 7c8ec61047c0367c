"""gopbrt_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``ssttuu/go-pbrt`` reference (a Go port of PBRT v3 exposed as a gRPC
service).  Nothing here is a translation of the Go code: the reference's
pointer-chasing, interface-dispatch, per-ray-recursion design becomes

  * SoA tables for primitives / materials / lights / textures
    (replacing the ``Shape`` / ``Material`` / ``Light`` Go interfaces,
    reference ``pkg/pbrt/shape.go:9-22`` etc.),
  * a wavefront integrator — flat ``[N]`` ray/path-state arrays stepped
    by a bounce loop under ``jit`` (replacing ``pkg/integrator/path.go:32-157``),
  * stateless counter-based sampling via ``jax.random`` (replacing the
    mutable ``Sampler`` tree in ``pkg/sampler/``),
  * device-sharded rendering via ``shard_map`` over a ``jax.sharding.Mesh``
    (replacing the 64-goroutine tile pool, ``pkg/pbrt/integrator.go:291-350``),
  * and end-to-end differentiability of the radiance estimate with
    respect to material / texture / light parameters (no analogue in the
    reference).

Layout:
  ops/       numeric kernels: geometry, intersection, BVH, sampling, BSDFs
  models/    scene representation, cameras, film, integrators, render driver
  parallel/  mesh construction + sharded render / gradient steps
  utils/     image IO, colour, progress
  service/   gRPC front-end mirroring ``proto/render/service.proto``
"""

__version__ = "0.1.0"
