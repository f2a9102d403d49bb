"""Single-frame render CLI — the static app, with the documented flags real.

The reference's README documents ``./render --eye X Y Z --rotate AXIS DEG``
(README.md:11) but static.cpp ignores argv entirely (static.cpp:23-24) and
would crash in its checked-in configuration (SURVEY.md §3.2). This CLI
implements that documented surface for real, plus the knobs the reference
hard-codes (resolution static.cpp:83, sun/camera presets :38-47, output
path :135).

Usage:
    python -m ceres_tpu.cli.render data/bunny.obj -o out.png \
        --eye 0 .1 -.3 --rotate y -145 --width 512 --height 512 --mode flat
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceres-render",
        description="Single-frame render of an OBJ mesh, ray traced "
                    "with JAX.")
    p.add_argument("input", help="OBJ mesh path")
    p.add_argument("-o", "--output", default="render.png",
                   help="output image (.png or .ppm) [render.png]")
    p.add_argument("--eye", nargs=3, type=float, default=[0.0, 0.1, -0.3],
                   metavar=("X", "Y", "Z"), help="camera position")
    p.add_argument("--dir", dest="direction", nargs=3, type=float,
                   default=None, metavar=("X", "Y", "Z"),
                   help="view direction (default: at mesh centroid)")
    p.add_argument("--up", nargs=3, type=float, default=[0.0, 1.0, 0.0],
                   metavar=("X", "Y", "Z"), help="camera up vector")
    p.add_argument("--fov", type=float, default=60.0,
                   help="horizontal field of view, degrees [60]")
    p.add_argument("--rotate", nargs=2, default=None,
                   metavar=("AXIS", "DEG"),
                   help="pre-rotate the mesh about x|y|z by DEG degrees")
    p.add_argument("--sun", nargs=3, type=float, default=[-50.0, 100.0, 0.0],
                   metavar=("X", "Y", "Z"), help="point-light position")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--mode", choices=["smooth", "flat", "normal"],
                   default="smooth", help="shading mode [smooth]")
    p.add_argument("--backend", choices=["megakernel", "bruteforce"],
                   default="megakernel")
    p.add_argument("--builder",
                   choices=["lbvh", "sweep", "binned", "sbvh", "ploc",
                            "reinsert"],
                   default="lbvh",
                   help="acceleration-structure builder (megakernel "
                        "backend). lbvh = on-device treelet cut "
                        "(default; builds in ~ms). The others are "
                        "host-side QUALITY builders cut into the same "
                        "structure (the reference's builder menu, e.g. "
                        "sweep = its anim app's SweepSAH): slower to "
                        "build, fewer block visits per frame")
    p.add_argument("--no-shadows", action="store_true",
                   help="skip shadow rays")
    p.add_argument("--sphere", action="append", nargs=4, type=float,
                   default=None, metavar=("X", "Y", "Z", "R"),
                   help="add a sphere primitive (bvh::Sphere, "
                        "sphere.hpp:13-61) at (X, Y, Z) with radius R; "
                        "repeatable")
    p.add_argument("--sharded", action="store_true",
                   help="shard rays across all available devices")
    p.add_argument("--primitive-sharded", action="store_true",
                   help="shard GEOMETRY across devices instead of rays "
                        "(for scenes exceeding one device's memory)")
    p.add_argument("-d", "--double", action="store_true",
                   help="render in float64 (the reference's '-d' Scalar "
                        "axis, anim.cpp:145-158). On the megakernel "
                        "backend the search runs the f32 walk kernel and "
                        "all values are recomputed in f64 at the winners; "
                        "use --backend bruteforce for the all-f64 oracle")
    p.add_argument("--d-exact", action="store_true",
                   help="implies -d; the megakernel search itself also "
                        "runs in float64 (the plain-JAX f64 cluster walk) "
                        "— the reference's Scalar=double semantics with "
                        "no f32 anywhere, for scenes beyond f32 "
                        "resolution. Slower than the accelerated -d")
    return p


def run(args) -> int:
    import numpy as np

    if args.d_exact:
        args.double = True
    if args.double:
        import jax

        jax.config.update("jax_enable_x64", True)

    from ceres_tpu.io.obj import load_obj
    from ceres_tpu.models.camera import Camera
    from ceres_tpu.models.transform import rotate_vertices_about_axis
    from ceres_tpu.render.renderer import render
    from ceres_tpu.utils.image import write_image
    from ceres_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    t0 = time.perf_counter()
    vertices, faces = load_obj(args.input)
    if faces.shape[0] == 0:
        print("Error: scene has no triangles", file=sys.stderr)
        return 1
    print(f"Loaded {vertices.shape[0]} vertices / {faces.shape[0]} faces "
          f"({time.perf_counter() - t0:.3f}s)")

    if args.rotate is not None:
        axis = {"x": 0, "y": 1, "z": 2}[args.rotate[0].lower()]
        vertices = np.asarray(
            rotate_vertices_about_axis(vertices, axis, float(args.rotate[1])))

    scalar = np.float64 if args.double else np.float32
    extra_cfg = {"f64_exact": True} if args.d_exact else {}
    vertices = np.asarray(vertices, scalar)
    eye = np.asarray(args.eye, scalar)
    direction = (np.asarray(args.direction, scalar)
                 if args.direction is not None
                 else vertices.mean(axis=0) - eye)
    camera = Camera.make(eye=eye, dir=direction, up=args.up, fov=args.fov,
                         dtype=scalar)
    sun = np.asarray(args.sun, scalar)
    spheres = None
    if args.sphere:
        sp = np.asarray(args.sphere, scalar)           # (S, 4)
        spheres = (sp[:, :3], sp[:, 3])

    t1 = time.perf_counter()
    if args.primitive_sharded:
        from ceres_tpu.parallel.sharded import render_primitive_sharded

        image, stats = render_primitive_sharded(
            vertices, faces, camera, sun, width=args.width,
            height=args.height, mode=args.mode, backend=args.backend,
            shadows=not args.no_shadows, spheres=spheres)
    elif args.sharded:
        from ceres_tpu.parallel.sharded import render_sharded

        image, stats = render_sharded(
            vertices, faces, camera, sun, width=args.width,
            height=args.height, mode=args.mode, backend=args.backend,
            shadows=not args.no_shadows, spheres=spheres)
    else:
        clusters = None
        if args.builder != "lbvh" and args.backend == "megakernel":
            from ceres_tpu.accel.cuts import build_clusters_quality
            from ceres_tpu.models.mesh import triangle_soup

            tb = time.perf_counter()
            clusters = build_clusters_quality(
                triangle_soup(np.asarray(vertices),
                              np.asarray(faces, np.int32),
                              with_normals=False),
                builder=args.builder)
            print(f"Built {args.builder} clusters "
                  f"({time.perf_counter() - tb:.3f}s)")
        image, stats = render(
            vertices, faces, camera, sun, width=args.width,
            height=args.height, mode=args.mode, backend=args.backend,
            shadows=not args.no_shadows, spheres=spheres,
            clusters=clusters, **extra_cfg)
    image = np.asarray(image)
    dt = time.perf_counter() - t1

    # The stats the reference prints per frame (anim.cpp:109-110).
    rays, hits = int(stats["rays"]), int(stats["hits"])
    print(f"Rays: {rays}")
    print(f"Hits: {hits}")
    print(f"Render (incl. compile): {dt:.3f}s  ({rays / dt / 1e6:.1f} Mrays/s)")

    write_image(args.output, image)
    print(f"Wrote {args.output}")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
