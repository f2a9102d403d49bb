"""On-card smoke test: render, gradient and animation on one GPU.

Drives the main path through the entry points a user calls, at full size
(bunny and dragon at 1920x1080, the 1,271,808-triangle subdivided bunny,
the reference anim app's 621x1344 turntable), with every walk-kernel
variant compiled for the card, and compares each phase with the repo's
plain reference: the ``bruteforce`` backend, or the plain-JAX walk for the
kernel itself. Any failed check ends the run with a non-zero exit; nothing
is caught and carried on. The last line of stdout is one JSON object that
names the device.

    python chip_smoke.py                # one card, every phase
    python chip_smoke.py --phases 0,1   # a subset (0 always runs)
    python chip_smoke.py --four         # only the sharded paths, 4 cards

Needs a GPU: it exits non-zero, printing no result, where JAX finds none.
Images and frames it writes go to chiprun_out/smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
SHARE = 1e-3      # pixels (or rays) allowed to differ: silhouette near-ties
PIX_TOL = 1e-3    # a pixel "differs" past this (tests/test_megakernel.py)
# Gradients (see Smoke.grads and PERF.md): vertices allowed outside the
# unit test's rule, and the relative L2 error allowed on a whole gradient.
GRAD_SHARE = 1e-2
GRAD_REL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


class Smoke:
    def __init__(self, card: str, rehearse: bool = False):
        import jax
        import numpy as np

        self.jax = jax
        self.np = np
        self.card = card
        # Full size: 1080p frames, the 4x-subdivided bunny, 65,536 sampled
        # pixels (128 sampled tiles for the plain walk), the anim app's
        # 621x1344. A rehearsal shrinks every size and forces the two-level
        # walk on the small scene, to check control flow on the CPU.
        self.rehearse = rehearse
        self.W, self.H = (64, 48) if rehearse else (1920, 1080)
        self.levels = 1 if rehearse else 4
        self.sample, self.tiles = (512, 2) if rehearse else (65536, 128)
        self.anim = (31, 45) if rehearse else (621, 1344)
        # A few thousand pixels make one near-tie a large share.
        self.share = 1e-2 if rehearse else SHARE
        if rehearse:
            from ceres_tpu.ops import megakernel as mk

            mk._HIER_MIN_CLUSTERS = 4

    # -- comparisons --------------------------------------------------

    def pixels(self, name, got, want, tol=PIX_TOL):
        np = self.np
        share = self.share
        d = np.abs(np.asarray(got, np.float32)
                   - np.asarray(want, np.float32)).reshape(-1, 3).max(-1)
        frac = float((d > tol).mean())
        log(f"[{name}] pixels off by > {tol}: {frac:.6%} (limit "
            f"{share:.3%}), max |diff| {float(d.max()):.4g} on {self.card}")
        check(frac < share, f"{name}: {frac:.6%} of pixels differ")
        return d > tol

    def counts(self, name, got, want):
        """rays/hits within the share of the reference's own count: a
        primary or shadow ray that flips at a near-tie moves a count by
        one."""
        for key in ("rays", "hits"):
            g, w = int(got[key]), int(want[key])
            log(f"[{name}] {key}: {g} vs reference {w} (limit "
                f"{self.share:.3%} of {w})")
            check(abs(g - w) <= self.share * w, f"{name}: {key} {g} vs {w}")

    def agree(self, name, got, want):
        np = self.np
        share = self.share
        got, want = np.asarray(got), np.asarray(want)
        check(got.size > 0, f"{name}: nothing to compare")
        frac = float((got != want).mean())
        log(f"[{name}] disagree: {frac:.6%} of {got.size} (limit "
            f"{share:.3%}) on {self.card}")
        check(frac < share, f"{name}: {frac:.6%} disagree")

    def grads(self, name, got, want):
        """The rule of tests/test_megakernel.py (rtol 1e-3, atol
        3e-6 * max|g|), widened for full frames. At bunny 1080p the two
        f32 backends differ at a handful of pixels that decide
        discontinuously: a near-tie winner across a shared edge, a
        shadow flip, or a shading kink (|n.l| or a channel's clip at 1
        within 1e-5). Such a pixel moves its whole gradient to other
        vertices; on the card every vertex outside the rule lay in the
        influence of one of them (14 of 2,503). The f32 bruteforce
        gradient fails the same rule against an f64 one on 0.28% of
        vertices, and TF32 controls fail it on 40%-64% with relative L2
        error 0.34-0.47. So the rule must hold on all but GRAD_SHARE of
        the vertices, and the whole gradient must agree to GRAD_REL in
        relative L2 norm."""
        np = self.np
        got, want = np.asarray(got), np.asarray(want)
        atol = 3e-6 * np.abs(want).max()
        ok = (np.abs(got - want) <= atol + 1e-3 * np.abs(want)).all(-1)
        bad = float(1.0 - ok.mean())
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        log(f"[{name}] rule rtol=1e-3 atol=3e-6*max|g| fails on {bad:.4%} "
            f"of {ok.size} vertices (limit {GRAD_SHARE:.1%}); relative L2 "
            f"error {rel:.3g} (limit {GRAD_REL:g}) on {self.card}")
        check(bad <= GRAD_SHARE and rel <= GRAD_REL, f"{name} gradients")

    def timed(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = self.jax.block_until_ready(fn(*args, **kw))
        log(f"[{name}] {time.perf_counter() - t0:.3f} s (incl. compile) "
            f"on {self.card}")
        return out

    # -- scenes ---------------------------------------------------------

    def scene(self, name):
        from ceres_tpu.render import scenes

        return scenes.bunny_scene() if name == "bunny" \
            else scenes.dragon_scene()

    def big_scene(self):
        from ceres_tpu.models.mesh import subdivide

        s = self.scene("bunny")
        v, f = subdivide(s.vertices, s.faces, self.levels)
        check(f.shape[0] == s.faces.shape[0] * 4 ** self.levels,
              f"subdivided bunny has {f.shape[0]} triangles")
        return s, v, f

    # -- phase 1: every kernel variant, compiled, against the plain walk --

    def kernel_variants(self, label, verts, faces, cam, sun, tiles=None):
        """Compile and run the walk in every mode on this scene at full
        frame size; compare with the plain-JAX walk in float32 (on a
        seeded sample of ``tiles`` whole tiles when given: tiles walk
        independently, so a tile's result does not depend on the others).
        """
        import jax.numpy as jnp

        from ceres_tpu.accel import clusters as cl
        from ceres_tpu.models.camera import camera_ray_columns
        from ceres_tpu.models.mesh import triangle_soup
        from ceres_tpu.ops import megakernel as mk
        from ceres_tpu.ops import walk_f64 as plain
        from ceres_tpu.utils import tiling

        np = self.np
        jax = self.jax
        jit = jax.jit
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        cs = jit(cl.build_clusters_treelet)(soup)
        n_c = int(cs.num_clusters)
        S = mk._super_factor(n_c)
        log(f"[kernel {label}] {int(faces.shape[0])} triangles, {n_c} "
            f"blocks, walk {'two-level' if S > 1 else 'flat'}")
        dirs = tuple(tiling.swizzle_plane(p)
                     for p in camera_ray_columns(cam, self.W, self.H))

        @jit
        def rays(soup, cs, eye, sun, dirs):
            """Primary hits, then shadow rays from the hit points."""
            hit = mk.closest_hit_common_origin(soup, eye, dirs, clusters=cs)
            t = jnp.where(hit.mask, hit.t, 0.0)
            pts = tuple(eye[a] + t * dirs[a] for a in range(3))
            to_sun = tuple(sun[a] - pts[a] for a in range(3))
            inv = jax.lax.rsqrt(sum(c * c for c in to_sun))
            sdir = tuple(c * inv for c in to_sun)
            org = tuple(pts[a] + 1e-4 * sdir[a] for a in range(3))
            tmin = jnp.where(hit.mask, hit.t * 1.001, 0.0)
            return dict(dirs=dirs, sdir=sdir, org=org,
                        seg=tuple(sun[a] - org[a] for a in range(3)),
                        skip=~hit.mask, tmin=tmin, tmax=tmin + 1.0,
                        center=jnp.mean(soup.p0, axis=0), eye=eye)

        a = rays(soup, cs, cam.eye, sun, dirs)
        R = dirs[0].shape[0]
        if tiles is None:
            rows = np.arange(R)
        else:
            # Tiles holding at least one primary hit, so every mode has
            # real work in the sample.
            lit = np.flatnonzero(~np.asarray(mk._pad_rays(
                a["skip"]).reshape(-1, mk.TILE)).all(axis=1))
            pick = np.sort(np.random.default_rng(0).choice(
                lit, min(tiles, lit.size), replace=False))
            rows = (pick[:, None] * mk.TILE
                    + np.arange(mk.TILE)[None, :]).reshape(-1)
            rows = rows[rows < R]
        b = jax.tree.map(lambda x: x[rows] if x.ndim else x, a)
        for key in ("center", "eye"):
            b[key] = a[key]

        cases = {
            "closest": (
                lambda c, s, a: mk._closest_search(c, a["eye"], a["dirs"]),
                lambda c, a: plain.closest_search(c, a["eye"], a["dirs"])),
            "closest+window": (
                lambda c, s, a: mk._closest_search(c, a["eye"], a["dirs"],
                                                   a["tmin"], a["tmax"]),
                lambda c, a: plain.closest_search(c, a["eye"], a["dirs"],
                                                  a["tmin"], a["tmax"])),
            "any": (
                lambda c, s, a: mk.any_hit(s, a["center"], a["org"],
                                           a["sdir"], skip=a["skip"],
                                           clusters=c, with_counts=True),
                lambda c, a: plain.any_hit(c, a["center"], a["org"],
                                           a["sdir"], skip=a["skip"])),
            "any_seg": (
                lambda c, s, a: mk.any_hit(s, a["center"], a["org"],
                                           a["seg"], skip=a["skip"],
                                           clusters=c, with_counts=True,
                                           segment=True),
                lambda c, a: plain.any_hit(c, a["center"], a["org"],
                                           a["seg"], skip=a["skip"],
                                           segment=True)),
        }
        for mode, (kern, ref) in cases.items():
            name = f"kernel {label} {mode}"
            t0 = time.perf_counter()
            compiled = jit(kern).lower(cs, soup, a).compile()
            log(f"[{name}] compiled in {time.perf_counter() - t0:.1f} s")
            out, cnt = self.timed(name + " run", compiled, cs, soup, a)
            ref_out, ref_cnt = self.timed(name + " plain walk", jit(ref),
                                          cs, b)
            out = np.asarray(out)[rows]
            ref_out = np.asarray(ref_out)
            log(f"[{name}] executed block visits: kernel "
                f"{int(cnt['traversal_steps'])} (all tiles), plain walk "
                f"{int(ref_cnt['traversal_steps'])} ({ref_out.size} rays)")
            if mode.startswith("closest"):
                self.agree(name + " hit mask", out >= 0, ref_out >= 0)
                both = (out >= 0) & (ref_out >= 0)
                self.agree(name + " winner slot", out[both], ref_out[both])
            else:
                self.agree(name + " occlusion", out, ref_out)

    # -- the phases -------------------------------------------------------

    def phase1(self):
        """Compile check: every walk variant at bunny 1080p shapes, the
        two-level walk at the 1.27M-triangle shapes; memory of a step."""
        import jax.numpy as jnp

        from ceres_tpu.render.renderer import RenderConfig, _render_jit

        s = self.scene("bunny")
        self.kernel_variants("bunny", s.vertices, s.faces, s.camera,
                             jnp.asarray(s.sun))
        s4, v4, f4 = self.big_scene()
        self.kernel_variants("subdivided", v4, f4, s4.camera,
                             jnp.asarray(s4.sun), tiles=self.tiles)
        cfg = RenderConfig(width=self.W, height=self.H, mode="smooth",
                           backend="megakernel")
        comp = _render_jit.lower(jnp.asarray(s.vertices),
                                 jnp.asarray(s.faces), s.camera,
                                 jnp.asarray(s.sun), cfg).compile()
        log(f"[render step bunny 1080p] memory_analysis: "
            f"{comp.memory_analysis()}")

    def render_pair(self, name, verts, faces, cam, sun):
        import ceres_tpu

        kw = dict(width=self.W, height=self.H, mode="smooth", shadows=True)
        img, st = self.timed(f"{name} megakernel render", ceres_tpu.render,
                             verts, faces, cam, sun, backend="megakernel",
                             **kw)
        t0 = time.perf_counter()
        self.jax.block_until_ready(ceres_tpu.render(
            verts, faces, cam, sun, backend="megakernel", **kw))
        log(f"[{name} megakernel render] warm {time.perf_counter() - t0:.4f}"
            f" s on {self.card}")
        ref, rst = self.timed(f"{name} bruteforce render", ceres_tpu.render,
                              verts, faces, cam, sun, backend="bruteforce",
                              **kw)
        self.pixels(f"{name} megakernel vs bruteforce", img, ref)
        self.counts(f"{name} megakernel vs bruteforce", st, rst)
        return self.np.asarray(img), self.np.asarray(ref)

    def phase2(self):
        """Bunny 1080p through ceres_tpu.render and cli.render."""
        from ceres_tpu.cli import render as cli_render
        from ceres_tpu.render import scenes
        from ceres_tpu.utils.image import read_png, to_uint8

        s = self.scene("bunny")
        img, _ = self.render_pair("bunny", s.vertices, s.faces, s.camera,
                                  s.sun)
        png = os.path.join(OUT, "bunny_1080p.png")
        t0 = time.perf_counter()
        rc = cli_render.main([scenes.bunny_path(), "-o", png, "--rotate",
                              "y", "-145", "--width", str(self.W), "--height",
                              str(self.H), "--mode", "smooth", "--backend",
                              "megakernel"])
        log(f"[bunny cli.render] rc={rc} "
            f"{time.perf_counter() - t0:.3f} s on {self.card}")
        check(rc == 0, "cli.render exit code")
        got = read_png(png).astype(self.np.float32) / 255.0
        want = to_uint8(img)[::-1].astype(self.np.float32) / 255.0
        self.pixels("bunny cli.render vs ceres_tpu.render", got, want,
                    tol=1.5 / 255.0)

    def phase3(self):
        """Dragon 1080p, the same comparison."""
        s = self.scene("dragon")
        self.render_pair("dragon", s.vertices, s.faces, s.camera, s.sun)

    def phase4(self):
        """1.27M triangles at 1080p: the two-level walk engages; compare
        with bruteforce on a seeded sample of pixels."""
        import jax.numpy as jnp

        import ceres_tpu
        from ceres_tpu.accel import clusters as cl
        from ceres_tpu.models.camera import camera_rays
        from ceres_tpu.models.mesh import triangle_soup
        from ceres_tpu.ops import megakernel as mk
        from ceres_tpu.render.renderer import RenderConfig, render_wavefront

        np = self.np
        s, v4, f4 = self.big_scene()
        vj, fj = jnp.asarray(v4), jnp.asarray(f4)
        cs = self.jax.jit(cl.build_clusters_treelet)(
            triangle_soup(vj, fj, with_normals=False))
        n_c = int(cs.num_clusters)
        S = cs.super_S if cs.super_first is not None \
            else mk._super_factor(n_c)
        log(f"[subdivided] {int(f4.shape[0])} triangles, {n_c} blocks, "
            f"super factor {mk._super_factor(n_c)} (S={S})")
        check(mk._super_factor(n_c) > 1, "two-level walk engaged")
        kw = dict(width=self.W, height=self.H, mode="smooth", shadows=True)
        img, st = self.timed("subdivided megakernel render", ceres_tpu.render,
                             v4, f4, s.camera, s.sun, backend="megakernel",
                             **kw)
        t0 = time.perf_counter()
        self.jax.block_until_ready(ceres_tpu.render(
            v4, f4, s.camera, s.sun, backend="megakernel", **kw))
        log(f"[subdivided megakernel render] warm {time.perf_counter() - t0:.4f}"
            f" s on {self.card}")
        idx = np.sort(np.random.default_rng(0).choice(self.W * self.H, self.sample,
                                                      replace=False))
        dirs = camera_rays(s.camera, self.W, self.H).reshape(-1, 3)[idx]
        cfg = RenderConfig(backend="bruteforce", **kw)
        soup = triangle_soup(vj, fj, with_normals=True)
        ref, _ = self.timed(
            "subdivided bruteforce sample",
            self.jax.jit(render_wavefront, static_argnames="config"),
            soup, s.camera, jnp.asarray(s.sun), dirs, config=cfg)
        got = np.asarray(img).reshape(-1, 3)[idx]
        self.pixels(f"subdivided megakernel vs bruteforce ({self.sample} pixels)",
                    got, np.asarray(ref))

    def phase5(self):
        """One make_train_step at bunny 1080p, and the image-loss
        gradient against the bruteforce backend."""
        import jax.numpy as jnp
        import optax

        from ceres_tpu.diff.inverse import (TrainState, image_loss,
                                            make_train_step)
        from ceres_tpu.render.renderer import RenderConfig, render_pipeline

        np = self.np
        jax = self.jax
        s = self.scene("bunny")
        vj = jnp.asarray(s.vertices)
        fj = jnp.asarray(s.faces)
        sun = jnp.asarray(s.sun)
        target = jnp.zeros((self.H, self.W, 3), jnp.float32)
        cfg = RenderConfig(width=self.W, height=self.H, mode="smooth",
                           backend="megakernel")
        opt = optax.adam(1e-3)
        step = make_train_step(fj, s.camera, sun, cfg, opt)
        params = {"vertices": vj}
        state, loss = self.timed("train step bunny 1080p", step,
                                 TrainState(params, opt.init(params)),
                                 target)
        check(bool(np.isfinite(float(loss))), "train-step loss finite")
        check(bool(np.isfinite(np.asarray(
            state.params["vertices"])).all()), "updated vertices finite")
        log(f"[train step] loss {float(loss):.6g}")

        def grad_of(backend):
            c = RenderConfig(width=self.W, height=self.H, mode="smooth",
                             backend=backend)

            def loss_fn(v):
                img, _ = render_pipeline(v, fj, s.camera, sun, c)
                return image_loss(img, target)

            return jax.jit(jax.grad(loss_fn))

        gm = np.asarray(self.timed("grad megakernel", grad_of("megakernel"),
                                   vj))
        gb = np.asarray(self.timed("grad bruteforce", grad_of("bruteforce"),
                                   vj))
        check(np.isfinite(gm).all(), "megakernel gradient finite")
        self.grads("grad bunny 1080p megakernel vs bruteforce", gm, gb)

    def phase6(self):
        """cli.anim at 621x1344, 4 frames, as PNG frames; each frame
        against a single-frame render of the same transform."""
        import jax.numpy as jnp

        import ceres_tpu
        from ceres_tpu.cli import anim as cli_anim
        from ceres_tpu.io.obj import load_obj
        from ceres_tpu.models.camera import Camera
        from ceres_tpu.parallel.sharded import turntable_transforms
        from ceres_tpu.render import scenes
        from ceres_tpu.utils.image import read_png, to_uint8

        np = self.np
        (aw, ah), nf = self.anim, 4
        verts, faces = load_obj(scenes.bunny_path())
        center = verts.mean(axis=0)
        radius = float(np.linalg.norm(verts - center, axis=1).max())
        eye = center + np.asarray([0.0, 0.0, -2.5 * radius], np.float32)
        outdir = os.path.join(OUT, "anim_frames")
        for old in (os.listdir(outdir) if os.path.isdir(outdir) else []):
            os.remove(os.path.join(outdir, old))
        t0 = time.perf_counter()
        rc = cli_anim.main([scenes.bunny_path(), "-o", outdir, "--frames",
                            str(nf), "--width", str(aw), "--height",
                            str(ah), "--eye"] + [repr(float(x)) for x in eye])
        log(f"[anim] rc={rc} {time.perf_counter() - t0:.3f} s on "
            f"{self.card}")
        check(rc == 0, "cli.anim exit code")
        cam = Camera.make(eye=eye, dir=center - eye, up=(0.0, 1.0, 0.0),
                          fov=60.0)
        sun = jnp.asarray([-50.0, 100.0, 0.0], jnp.float32)
        tracks = turntable_transforms(nf)
        hi = self.jax.lax.Precision.HIGHEST
        for k in range(nf):
            tf = self.jax.tree.map(lambda x: x[k], tracks)
            cam_k = Camera(eye=tf(cam.eye),
                           dir=jnp.matmul(tf.a, cam.dir, precision=hi),
                           up=cam.up, fov=cam.fov)
            img, _ = ceres_tpu.render(verts, faces, cam_k, tf(sun),
                                      width=aw, height=ah, mode="smooth",
                                      backend="megakernel")
            got = read_png(os.path.join(outdir, f"frame_{k:04d}.png"))
            want = to_uint8(np.asarray(img))[::-1]
            self.pixels(f"anim frame {k} vs single-frame render",
                        got.astype(np.float32) / 255.0,
                        want.astype(np.float32) / 255.0, tol=1.5 / 255.0)

    def phase7(self):
        """The card-only tests, in this process (one process per card)."""
        import pytest

        os.environ["CERES_TEST_PLATFORM"] = "gpu"
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests")])
        log(f"[pytest -m gpu] exit code {int(rc)} on {self.card}")
        check(int(rc) == 0, "pytest -m gpu")

    # -- four cards -------------------------------------------------------

    def four(self):
        """The sharded paths on four cards, each against the same
        computation on one card."""
        import jax.numpy as jnp
        import optax

        from ceres_tpu.diff.inverse import TrainState, make_train_step
        from ceres_tpu.io.obj import load_obj
        from ceres_tpu.models.camera import Camera
        from ceres_tpu.parallel.sharded import (
            device_mesh, render_frames_sharded, render_primitive_sharded,
            turntable_transforms)
        from ceres_tpu.render import scenes
        from ceres_tpu.render.renderer import RenderConfig

        np = self.np
        jax = self.jax
        devs = jax.devices()
        check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
        one = device_mesh(devices=devs[:1])

        verts, faces = load_obj(scenes.bunny_path())
        center = verts.mean(axis=0)
        radius = float(np.linalg.norm(verts - center, axis=1).max())
        eye = center + np.asarray([0.0, 0.0, -2.5 * radius], np.float32)
        cam = Camera.make(eye=eye, dir=center - eye, up=(0.0, 1.0, 0.0),
                          fov=60.0)
        sun = np.asarray([-50.0, 100.0, 0.0], np.float32)
        kw = dict(width=self.anim[0], height=self.anim[1], mode="smooth",
                  backend="megakernel")
        tracks = turntable_transforms(4)
        f4, st4 = self.timed("frames sharded x4", render_frames_sharded,
                             verts, faces, cam, sun, tracks,
                             mesh=device_mesh(), **kw)
        f1, st1 = self.timed("frames one card", render_frames_sharded,
                             verts, faces, cam, sun, tracks, mesh=one, **kw)
        self.pixels("render_frames_sharded 4 cards vs 1", f4, f1)
        self.counts("render_frames_sharded 4 cards vs 1", st4, st1)

        d = scenes.dragon_scene()
        kw = dict(width=self.W, height=self.H, mode="smooth", backend="megakernel")
        p4, sp4 = self.timed("primitive sharded x4", render_primitive_sharded,
                             d.vertices, d.faces, d.camera, d.sun,
                             mesh=device_mesh(), **kw)
        p1, sp1 = self.timed("primitive one card", render_primitive_sharded,
                             d.vertices, d.faces, d.camera, d.sun, mesh=one,
                             **kw)
        self.pixels("render_primitive_sharded 4 cards vs 1", p4, p1)
        self.counts("render_primitive_sharded 4 cards vs 1", sp4, sp1)

        s = self.scene("bunny")
        cfg = RenderConfig(width=self.W, height=self.H, mode="smooth",
                           backend="megakernel")
        vj = jnp.asarray(s.vertices)
        target = jnp.zeros((self.H, self.W, 3), jnp.float32)
        grads = {}
        for name, mesh in (("2x2 mesh", device_mesh(num_frames_axis=2)),
                           ("one card", one)):
            opt = optax.sgd(1.0)
            step = make_train_step(s.faces, s.camera, s.sun, cfg, opt,
                                   mesh=mesh)
            params = {"vertices": vj}
            state, loss = self.timed(f"train step {name}", step,
                                     TrainState(params, opt.init(params)),
                                     target)
            # With sgd(1.0) the update is exactly -grad.
            grads[name] = np.asarray(vj - state.params["vertices"])
            log(f"[train step {name}] loss {float(loss):.8g}")
        self.grads("train step 2x2 mesh vs one card", grads["2x2 mesh"],
                   grads["one card"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
                    help="comma-separated phases to run [all]")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at tiny sizes to check control "
                         "flow (kernels interpreted); prints no result")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "ceres_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ceres_tpu.utils import runtime

    # Phase 0: the device.
    smi = runtime.nvidia_smi_line()
    log(f"card (nvidia-smi name, power.limit): {smi}")
    dev = runtime.device_report()
    log(f"jax device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    if dev["platform"] != "gpu" and not args.rehearse:
        print(f"no GPU: JAX runs on {dev['platform']!r}", file=sys.stderr)
        return 1
    log(f"compile cache: {runtime.enable_compile_cache()}")
    os.makedirs(OUT, exist_ok=True)
    smoke = Smoke(f"{dev['kind']} [{smi}]", rehearse=args.rehearse)
    t_all = time.perf_counter()
    if args.four:
        smoke.four()
    else:
        for p in sorted({int(x) for x in args.phases.split(",") if x}):
            t0 = time.perf_counter()
            log(f"== phase {p}: {getattr(Smoke, f'phase{p}').__doc__.split(chr(10))[0]}")
            getattr(smoke, f"phase{p}")()
            log(f"== phase {p} done in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s on "
        f"{smoke.card}")
    if args.rehearse:
        return 0
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
