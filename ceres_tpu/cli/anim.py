"""Turntable animation CLI — the anim app (include/anim.cpp:19-159).

Per frame the reference rotates camera eye/dir and sun by 360/N degrees
about +y (anim.cpp:77-89), renders, and writes all frames as an animated
file via Magick++ (default ``render.mp4``, anim.cpp:112-127). Here the
frames are *batched*: keyframe Transform tracks go through
render_frames_sharded, sharding (frames x rows) across every available
device. The default output is a directory of PNG frames, which needs no
video encoder; ``.mp4`` (OpenCV) and ``.gif`` (imageio) are optional and
checked for before anything renders.

Usage:
    python -m ceres_tpu.cli.anim data/bunny.obj -o frames/ --frames 60
    python -m ceres_tpu.cli.anim data/bunny.obj -o render.mp4 --frames 60
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceres-anim",
        description="Turntable animation of an OBJ mesh, ray traced "
                    "with JAX.")
    p.add_argument("input", help="OBJ mesh path")
    p.add_argument("-o", "--output", default="render_frames",
                   help="output: a directory of PNG frames, or a video "
                        "(.mp4 needs opencv-python, .gif needs imageio) "
                        "[render_frames]")
    p.add_argument("--frames", type=int, default=60,
                   help="number of turntable frames [60]")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--eye", nargs=3, type=float, default=None,
                   metavar=("X", "Y", "Z"),
                   help="camera position (default: auto-framed)")
    p.add_argument("--up", nargs=3, type=float, default=[0.0, 1.0, 0.0],
                   metavar=("X", "Y", "Z"))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--sun", nargs=3, type=float, default=[-50.0, 100.0, 0.0],
                   metavar=("X", "Y", "Z"))
    p.add_argument("--axis", nargs=3, type=float, default=[0.0, 1.0, 0.0],
                   help="turntable rotation axis [0 1 0]")
    p.add_argument("--width", type=int, default=621)   # anim.cpp:140-141
    p.add_argument("--height", type=int, default=1344)
    p.add_argument("--mode", choices=["smooth", "flat", "normal"],
                   default="smooth")
    p.add_argument("--backend", choices=["megakernel", "bruteforce"],
                   default="megakernel")
    p.add_argument("--builder",
                   choices=["lbvh", "sweep", "binned", "sbvh", "ploc",
                            "reinsert"],
                   default="lbvh",
                   help="acceleration-structure builder. Frame loops "
                        "amortize a host-side QUALITY build best: sweep "
                        "(the reference anim app's own SweepSAH choice, "
                        "anim.cpp:62), at the cost of a host-side build")
    p.add_argument("--batch", type=int, default=None,
                   help="frames rendered per dispatch (default 4: "
                        "batching amortizes per-frame fixed cost)")
    p.add_argument("-d", "--double", action="store_true",
                   help="render in float64 — the reference anim app's one "
                        "real flag (anim.cpp:145-158). On the megakernel "
                        "backend the search runs the f32 walk kernel and "
                        "all values (t/u/v, shading) are recomputed in f64 "
                        "at the winners; use --backend bruteforce for the "
                        "all-f64 O(R x T) oracle")
    p.add_argument("--save-frames", metavar="DIR", default=None,
                   help="write each frame to DIR/frame_NNNN.png as soon as "
                        "it is rendered; on restart, already-written frames "
                        "are skipped (incremental checkpoint/resume — the "
                        "reference buffers all frames in RAM and writes "
                        "once at the end, anim.cpp:44,124-127)")
    return p


_VIDEO_ENCODERS = {".mp4": ("cv2", "opencv-python"),
                   ".gif": ("imageio", "imageio")}


def _video_encoder(path: str):
    """The encoder module for a video ``path``; None for a frame
    directory. Fails before any rendering when the encoder is missing."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _VIDEO_ENCODERS:
        if ext:
            raise SystemExit(f"unsupported output {path!r}: use a directory "
                             f"of PNG frames, .mp4 or .gif")
        return None
    module, package = _VIDEO_ENCODERS[ext]
    try:
        return __import__(module)
    except ImportError:
        raise SystemExit(f"writing {ext} needs the {package} package, which "
                         f"is not installed; write PNG frames to a "
                         f"directory instead (-o DIR)") from None


def _write_video(path: str, encoder, frames_u8, fps: int) -> None:
    if path.lower().endswith(".gif"):
        encoder.mimsave(path, list(frames_u8), duration=1000.0 / fps, loop=0)
    else:
        cv2 = encoder
        h, w = frames_u8[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        for f in frames_u8:
            vw.write(f[:, :, ::-1])  # RGB -> BGR
        vw.release()


def run(args) -> int:
    import jax
    import numpy as np

    encoder = _video_encoder(args.output)
    if encoder is None and not args.save_frames:
        # A frame directory IS the incremental checkpoint: frames land as
        # soon as each batch renders, and a restart resumes.
        args.save_frames = args.output
    if args.double:
        jax.config.update("jax_enable_x64", True)

    from ceres_tpu.io.obj import load_obj
    from ceres_tpu.models.camera import Camera
    from ceres_tpu.parallel.sharded import (
        device_mesh, render_frames_sharded, turntable_transforms)
    from ceres_tpu.utils.image import read_png, to_uint8, write_png
    from ceres_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    t0 = time.perf_counter()
    vertices, faces = load_obj(args.input)
    if faces.shape[0] == 0:
        print("Error: scene has no triangles", file=sys.stderr)
        return 1
    if args.double:
        vertices = vertices.astype(np.float64)
    print(f"Loaded {vertices.shape[0]} vertices / {faces.shape[0]} faces")

    dtype = np.float64 if args.double else np.float32
    center = vertices.mean(axis=0)
    if args.eye is not None:
        eye = np.asarray(args.eye, dtype)
    else:
        # Auto-frame: back off along -z by 2.5x the bounding radius.
        radius = float(np.linalg.norm(vertices - center, axis=1).max())
        eye = center + np.asarray([0, 0, -2.5 * radius], dtype)
    camera = Camera.make(eye=eye, dir=center - eye, up=args.up, fov=args.fov,
                         dtype=dtype)
    sun = np.asarray(args.sun, dtype)

    n_dev = len(jax.devices())
    mesh = device_mesh()  # all devices on the "rays" axis; frames batched below
    tracks = turntable_transforms(args.frames, axis=args.axis, dtype=dtype)

    def _frame_path(k: int) -> str:
        return os.path.join(args.save_frames, f"frame_{k:04d}.png")

    if args.save_frames:
        os.makedirs(args.save_frames, exist_ok=True)

    clusters = None
    if args.builder != "lbvh" and args.backend == "megakernel":
        from ceres_tpu.accel.cuts import build_clusters_quality
        from ceres_tpu.models.mesh import triangle_soup

        tb = time.perf_counter()
        clusters = build_clusters_quality(
            triangle_soup(np.asarray(vertices, dtype),
                          np.asarray(faces, np.int32), with_normals=False),
            builder=args.builder)
        print(f"Built {args.builder} clusters "
              f"({time.perf_counter() - tb:.3f}s)")

    batch = args.batch or min(args.frames, 4)
    total_rays = 0
    frames_u8 = [None] * args.frames
    skipped = 0
    t1 = time.perf_counter()
    for start in range(0, args.frames, batch):
        stop = min(start + batch, args.frames)
        if args.save_frames and all(
                os.path.exists(_frame_path(k)) for k in range(start, stop)):
            skipped += stop - start
            continue  # resume: this batch is already on disk
        tf = jax.tree.map(lambda x: x[start:stop], tracks)
        frames, stats = render_frames_sharded(
            vertices, faces, camera, sun, tf, mesh=mesh,
            width=args.width, height=args.height, mode=args.mode,
            backend=args.backend, clusters=clusters)
        frames = np.asarray(frames)
        total_rays += int(stats["rays"])
        for k in range(frames.shape[0]):
            u8 = to_uint8(frames[k])[::-1]  # flip like PPM
            frames_u8[start + k] = u8
            if args.save_frames:
                write_png(_frame_path(start + k), frames[k])
        print(f"frames {start}..{stop - 1} done "
              f"({time.perf_counter() - t1:.2f}s elapsed)")
    dt = time.perf_counter() - t1
    if skipped:
        print(f"Resumed: {skipped} frame(s) already in {args.save_frames}")
    if args.save_frames:
        # Fill skipped frames back in from disk for the video assembly.
        for k in range(args.frames):
            if frames_u8[k] is None:
                frames_u8[k] = read_png(_frame_path(k))

    print(f"Total Rays: {total_rays}")  # anim.cpp:129
    print(f"Total render: {dt:.2f}s on {n_dev} device(s) "
          f"({total_rays / dt / 1e6:.1f} Mrays/s)")
    if encoder is not None:
        _write_video(args.output, encoder, frames_u8, args.fps)
    print(f"Wrote {args.output} ({args.frames} frames)")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
