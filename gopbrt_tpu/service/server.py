"""gRPC render daemon: the service + process layer.

Counterpart of the reference's service stack:
  * RPC handler (``internal/render/server.go:29-172``): builds the demo
    scene and renders — here the scene build is cached and the render runs
    the wavefront path tracer (optionally sharded over all local devices).
  * daemon (``cmd/pbrtd/main.go:16-38``): listen :3001, register service,
    server reflection (hand-rolled v1+v1alpha, service/reflection.py —
    main.go:28); graceful SIGINT/SIGTERM shutdown
    (``internal/signal/signal.go:11-25``, ``cmd/pbrtd/server.go:10-26``).

Uses grpc generic handlers with the hand-rolled codec in service/proto.py
(wire-compatible with proto/render/service.proto), so grpcurl clients of
the Go daemon work unchanged.  grpc (and protobuf, for reflection) is
imported only by ``make_server``: ``RenderService`` itself needs
neither.  Improvements over the reference:
  * scene_id selects from a registry (demo / cornell / mesh / glass — the
    BASELINE gallery); the reference ignores it (service.proto:10),
  * the request ``time`` field (ignored by the reference, service.proto:11)
    pins the camera shutter to that instant — renders an animated scene at
    a chosen frame time,
  * superset fields spp=5 / max_depth=6 expose sampling controls,
  * scene builds are cached per scene_id.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from concurrent import futures

from gopbrt_tpu.service.proto import RenderRequest, RenderResponse

SERVICE_NAME = "render.Render"
DEFAULT_PORT = 3001


class RenderService:
    """The Render/Render RPC (server.go:29-172 equivalent)."""

    def __init__(self, use_mesh: bool = True, out_dir: str = "build"):
        self.out_dir = out_dir
        self.use_mesh = use_mesh
        self._scenes = {}
        self._lock = threading.Lock()

    #: scene registry: id -> builder (the BASELINE gallery; "demo" is the
    #: reference's hardcoded scene; unknown ids fall back to demo, matching
    #: the reference's render-the-demo-regardless behaviour)
    @staticmethod
    def _build_scene(scene_id: str):
        from gopbrt_tpu.models import gallery
        from gopbrt_tpu.models.demo import build_demo_scene

        if scene_id == "cornell":
            return gallery.config2()[0]
        if scene_id == "mesh":
            return gallery.config3()[0]
        if scene_id == "glass":
            return gallery.config4()[0]
        return build_demo_scene()

    def _get_scene(self, scene_id: str):
        with self._lock:
            if scene_id not in self._scenes:
                self._scenes[scene_id] = self._build_scene(scene_id)
            return self._scenes[scene_id]

    def render(self, request: RenderRequest, context) -> RenderResponse:
        import jax
        import jax.numpy as jnp

        from gopbrt_tpu.models import film as film_mod
        from gopbrt_tpu.models import render as render_mod
        from gopbrt_tpu.models.demo import build_demo_camera, demo_settings
        from gopbrt_tpu.parallel import shard as shard_mod

        width = request.width or 1920
        height = request.height or 1080
        scene_id = request.scene_id or "demo"
        scene = self._get_scene(scene_id)
        if scene_id == "cornell":
            from gopbrt_tpu.models import gallery

            camera = gallery.config2(width, height)[1]
        elif scene_id == "mesh":
            from gopbrt_tpu.models.meshes import mesh_camera

            camera = mesh_camera(width, height)
        elif scene_id == "glass":
            from gopbrt_tpu.models import gallery

            camera = gallery.config4(width, height)[1]
        else:
            camera = build_demo_camera(width, height)
        if request.time:
            # honor the request's animation time (service.proto:11, ignored
            # by the reference): pin the shutter to that instant
            t = float(min(max(request.time, 0.0), 1.0))
            camera = camera._replace(
                shutter_open=jnp.asarray(t, jnp.float32),
                shutter_close=jnp.asarray(t, jnp.float32),
            )
        settings = demo_settings(
            width=width, height=height, spp=request.spp or 16,
        )
        if request.max_depth:
            settings = settings._replace(max_depth=int(request.max_depth))

        if self.use_mesh and len(jax.devices()) > 1:
            mesh = shard_mod.make_mesh()
            img = shard_mod.render_sharded(mesh, scene, camera, settings)
        else:
            img = render_mod.render(scene, camera, settings)

        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir,
            "render-" + time.strftime("%Y-%m-%dT%H:%M:%S") + ".png",
        )
        film_mod.write_png(path, img)
        return RenderResponse(path=path)


def make_server(
    port: int = DEFAULT_PORT, service: RenderService | None = None
) -> "grpc.Server":
    import grpc

    service = service or RenderService()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    rpc = grpc.unary_unary_rpc_method_handler(
        service.render,
        request_deserializer=RenderRequest.FromString,
        response_serializer=RenderResponse.SerializeToString,
    )
    handler = grpc.method_handlers_generic_handler(SERVICE_NAME, {"Render": rpc})
    from gopbrt_tpu.service.reflection import reflection_handlers

    server.add_generic_rpc_handlers(
        (handler, *reflection_handlers([SERVICE_NAME]))
    )
    server.add_insecure_port(f"[::]:{port}")
    return server


def main(port: int = DEFAULT_PORT) -> None:
    """Daemon entry (cmd/pbrtd/main.go): serve until SIGINT/SIGTERM."""
    from gopbrt_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    server = make_server(port)
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    server.start()
    print(f"pbrtd listening on :{port}")
    stop.wait()
    server.stop(grace=5).wait()
    print("shutdown complete")


if __name__ == "__main__":
    main(int(os.environ.get("PBRTD_PORT", DEFAULT_PORT)))
