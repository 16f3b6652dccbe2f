"""Command-line app shell (counterpart of ``distributionraytracer_tpu.cli``).

The reference prompts for a P3F name, renders, writes RT_Output.png and
prints the wall-clock (main.cpp:968-1111).  Here:

    python -m distributionraytracer_tpu_torch render random \\
        --res 800 600 --spp 16 --device cuda -o RT_Output.png

    python -m distributionraytracer_tpu_torch render scene.p3f \\
        [--spp N] [--motion-blur] [--progressive N] [--seed S]

A grid or BVH scene prints its accel build (cells or nodes, seconds, which
builder) before its backend.  ``render --sharded`` shards the pixel rows
over a ``torch.distributed`` group, one process a card (``torchrun
--nproc-per-node N -m distributionraytracer_tpu_torch render ... --sharded``
with ``DRT_DISTRIBUTED=1``, or ``DRT_COORDINATOR``/``DRT_NUM_PROCESSES``/
``DRT_PROCESS_ID``); without one it runs at world size 1, on a group it
makes itself from a ``file://`` store in a temporary directory.  Rank 0
writes the image.

    python -m distributionraytracer_tpu_torch pathtrace --scene 0 \\
        -o PT_Output.png --res 800 600 --spp 16 [--bounces 10]

    python -m distributionraytracer_tpu_torch view scene.p3f \\
        [--port 8765] [--res 512 512] [--spp 1]
    python -m distributionraytracer_tpu_torch view --pt [--pt-scene 0] \\
        [--res 400 300] [--spp 1] [--bounces 10] [--cubemap DIR]

``view`` serves the progressive browser viewer on 127.0.0.1 (open
http://localhost:8765/): the Whitted renderer on a P3F scene, or with
``--pt`` the path tracer on a GLSL scene.

All of them run on the card (``--device cuda``) unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cmd_render(args):
    import torch

    from distributionraytracer_tpu_torch.integrator.render import (
        default_config,
    )
    from distributionraytracer_tpu_torch.renderer import (
        Renderer, resolve_device,
    )
    from distributionraytracer_tpu_torch.scene import (
        create_random_scene, load_p3f,
    )
    from distributionraytracer_tpu_torch.utils.image import write_png

    device = resolve_device(args.device)
    if args.scene == "random":
        # the reference's P3F_scene=false path (main.cpp:996-1001):
        # built-in "Ray Tracing in One Weekend" scene (scene.cpp:742-815)
        scene = create_random_scene(seed=args.seed)
    else:
        scene = load_p3f(args.scene)
    if args.res:
        scene = scene.with_resolution(*args.res)
    st = scene.static
    print(f"Resolution {st.res_x}x{st.res_y}, spp={st.spp}, "
          f"accel={st.accel}, objects={st.n_objects}, lights={st.n_lights}, "
          f"device={device}")
    cfg = default_config(scene)
    if args.spp is not None:
        cfg = cfg.replace(spp=args.spp)
    if args.motion_blur:
        cfg = cfg.replace(motion_blur=True)
    if args.sharded:
        _render_sharded(args, scene, cfg, device)
        return
    r = Renderer(scene, cfg, device=device, verbose=True)  # grid/BVH build
    print(f"backend: {r.executed_backend()}")
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    if args.progressive:
        state = r.progressive_init()
        for _ in range(args.progressive):
            state = r.progressive_step(state, gen)
        img = state[0]
        _sync(device)
        print(f"progressive {args.progressive} frames: "
              f"{time.perf_counter() - t0:.3f}s")
    else:
        img, nrays = r.render(gen, return_rays=True)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"Whitted/distribution render: {dt:.3f}s, "
              f"{int(nrays)} rays ({int(nrays) / dt:.4g} rays/s, first "
              "call, kernel build included)")
    write_png(args.output, img)
    print(f"Image file created: {args.output}")


def _render_sharded(args, scene, cfg, device):
    """Pixel rows over the process group, the accel tables replicated (the
    multi-process analogue of main.cpp:603's OpenMP loop)."""
    import torch
    import torch.distributed as dist

    from distributionraytracer_tpu_torch.parallel.mesh import (
        init_file_group, make_row_mesh, render_image_sharded,
    )
    from distributionraytracer_tpu_torch.renderer import build_accel
    from distributionraytracer_tpu_torch.utils.image import write_png

    store = None
    if not dist.is_initialized():
        store = tempfile.mkdtemp(prefix="drt_group_")
        init_file_group(device, os.path.join(store, "store"))
    try:
        mesh = make_row_mesh(device)
        scene = scene.to(mesh.device)
        tables = None
        if scene.static.accel:
            tables = build_accel(scene, verbose=mesh.rank == 0,
                                 motion_blur=cfg.motion_blur,
                                 packet_kernel=cfg.packet_kernel
                                 ).tabs.to(mesh.device)
        gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
        t0 = time.perf_counter()
        img = render_image_sharded(scene, cfg, mesh, generator=gen,
                                   accel=tables)
        _sync(mesh.device)
        if mesh.rank == 0:
            print(f"sharded render over {mesh.world} process(es), backend "
                  f"{dist.get_backend()}: {time.perf_counter() - t0:.3f}s")
            write_png(args.output, img)
            print(f"Image file created: {args.output}")
    finally:
        if store is not None:
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)


def _cmd_view(args):
    from distributionraytracer_tpu_torch import viewer
    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator.render import (
        default_config,
    )
    from distributionraytracer_tpu_torch.scene import load_p3f

    if args.pt:
        cfg = RenderConfig(max_bounces=args.bounces)
        viewer.serve_pt(args.pt_scene, cfg, port=args.port,
                        res=tuple(args.res) if args.res else (400, 300),
                        cubemap=args.cubemap, chunk_spp=args.spp or 1,
                        device=args.device)
        return
    if args.scene is None:
        raise SystemExit(
            "view: a scene path is required unless --pt is given")
    scene = load_p3f(args.scene)
    if args.res:
        scene = scene.with_resolution(*args.res)
    cfg = default_config(scene)
    if args.spp is not None:
        cfg = cfg.replace(spp=args.spp)
    viewer.serve(scene, cfg, port=args.port, device=args.device)


# default orbit camera per GLSL scene (P3D_RT.glsl:687-735 defaults)
PT_CAMERAS = {0: ([6.0, 1.6, -6.0], [0.0, 0.5, 0.0]),
              4: ([0.0, -1.0, -2.0], [0.0, -1.0, 10.0])}
PT_CAMERA_DEFAULT = ([0.0, -3.0, -6.0], [0.0, -3.0, 10.0])


def _cmd_pathtrace(args):
    import torch

    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator.pathtracer import (
        render_pt, to_gamma,
    )
    from distributionraytracer_tpu_torch.renderer import resolve_device
    from distributionraytracer_tpu_torch.scene.pt_scenes import (
        SCENE_BUILDERS,
    )
    from distributionraytracer_tpu_torch.utils.image import write_png

    device = resolve_device(args.device)
    sky_faces = sky_res = None
    if args.cubemap:
        from distributionraytracer_tpu_torch.scene.skybox import load_skybox
        sky_faces, sky_res = load_skybox(args.cubemap)
    builder = SCENE_BUILDERS[args.scene]
    scene = (builder() if args.scene == 0
             else builder(sky_faces, sky_res)).to(device)
    cfg = RenderConfig(max_bounces=args.bounces)
    eye, at = PT_CAMERAS.get(args.scene, PT_CAMERA_DEFAULT)
    eye = args.eye or eye
    at = args.at or at
    W, H = args.res
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    img = render_pt(scene, cfg, W, H, gen, eye=eye, at=at, spp=args.spp)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"path trace: {dt:.3f}s ({W}x{H} @ {args.spp}spp, "
          f"{cfg.max_bounces} bounces, device={device}, "
          f"{W * H * args.spp / dt / 1e6:.4g} Msamples/s, first call, "
          "kernel build included)")
    write_png(args.output, to_gamma(img))
    print(f"Image file created: {args.output}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="distributionraytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="Whitted/distribution render of a P3F "
                       "scene, or of the built-in Shirley scene "
                       "(scene name 'random')")
    r.add_argument("scene", help="path to a .p3f file, or 'random' for the "
                   "built-in Ray-Tracing-in-One-Weekend scene")
    r.add_argument("-o", "--output", default="RT_Output.png")
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--res", type=int, nargs=2, default=None,
                   help="override scene resolution")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--motion-blur", action="store_true")
    r.add_argument("--progressive", type=int, default=0, metavar="FRAMES")
    r.add_argument("--sharded", action="store_true",
                   help="shard pixel rows over the torch.distributed group "
                        "(torchrun with DRT_DISTRIBUTED=1, or "
                        "DRT_COORDINATOR); world size 1 without one")
    r.add_argument("--device", default="cuda",
                   help="torch device, e.g. 'cuda' (default) or 'cpu'")
    r.set_defaults(fn=_cmd_render)

    v = sub.add_parser("view", help="interactive progressive viewer "
                                    "(orbit camera, browser UI)")
    v.add_argument("scene", nargs="?", default=None,
                   help="P3F scene path (Whitted mode); omit with --pt")
    v.add_argument("--port", type=int, default=8765)
    v.add_argument("--res", type=int, nargs=2, default=None)
    v.add_argument("--spp", type=int, default=None,
                   help="Whitted: batch spp; --pt: spp per frame chunk")
    v.add_argument("--pt", action="store_true",
                   help="interactive progressive PATH TRACER "
                        "(P3D_RT.html harness parity)")
    v.add_argument("--pt-scene", type=int, default=0, choices=range(5),
                   help="GLSL scene id for --pt")
    v.add_argument("--bounces", type=int, default=10)
    v.add_argument("--cubemap", default=None,
                   help="skybox dir with right/left/top/bottom/front/back.jpg"
                        " (decoded with PIL)")
    v.add_argument("--device", default="cuda",
                   help="torch device, e.g. 'cuda' (default) or 'cpu'")
    v.set_defaults(fn=_cmd_view)

    t = sub.add_parser("pathtrace",
                       help="Monte Carlo path trace (GLSL scenes 0-4)")
    t.add_argument("--scene", type=int, default=0, choices=range(5))
    t.add_argument("-o", "--output", default="PT_Output.png")
    t.add_argument("--res", type=int, nargs=2, default=[800, 600])
    t.add_argument("--spp", type=int, default=16)
    t.add_argument("--bounces", type=int, default=10)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--cubemap", default=None,
                   help="skybox dir with right/left/top/bottom/front/back.jpg"
                        " (decoded with PIL)")
    t.add_argument("--eye", type=float, nargs=3, default=None)
    t.add_argument("--at", type=float, nargs=3, default=None)
    t.add_argument("--device", default="cuda",
                   help="torch device, e.g. 'cuda' (default) or 'cpu'")
    t.set_defaults(fn=_cmd_pathtrace)

    args = p.parse_args(argv)
    # multi-process: before the first device query
    import torch.distributed as dist

    from distributionraytracer_tpu_torch.parallel.mesh import (
        maybe_init_distributed,
    )
    started = (not dist.is_initialized()
               and maybe_init_distributed(args.device, verbose=True))
    try:
        args.fn(args)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
