"""Ablation timings for the headline 1080p demo pass (see BENCH_NOTES.md)."""
import os, sys, time, json
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp
from gopbrt_tpu.compile_cache import enable_compile_cache
enable_compile_cache()
from gopbrt_tpu.models import film as film_mod
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene

W,H = 1920,1080
def run(tag, **kw):
    scene = build_demo_scene(accelerator=kw.pop("accel","bvh"))
    cam = build_demo_camera(W,H)
    s = render_mod.RenderSettings(width=W,height=H,spp=1,max_depth=kw.pop("depth",10),
        integrator=kw.pop("integ","path"), samples_per_pass=1, **kw)
    film = film_mod.new_film(W,H)
    out = render_mod.render_pass(scene,cam,film,s,jnp.uint32(0)); jax.block_until_ready(out)
    t0=time.perf_counter()
    for i in range(3):
        out = render_mod.render_pass(scene,cam,out,s,jnp.uint32(i+1))
    jax.block_until_ready(out)
    dt=(time.perf_counter()-t0)/3
    print(json.dumps({"tag":tag,"ms":round(dt*1e3,1),"mrays_s":round(W*H/dt/1e6,2)}), flush=True)

run("depth10_path")
run("depth5", depth=5)
run("depth2", depth=2)
run("depth1", depth=1)
run("depth10_direct", integ="direct")
