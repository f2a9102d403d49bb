"""shard_map rendering over a device mesh.

The reference's only parallelism is one OpenMP ``parallel for`` over the
pixel grid (include/render.hpp:104). The mapping here (SURVEY.md §2
parallelism table):

  * rays/pixels  -> "rays" mesh axis: each device renders a contiguous block
    of image rows, generating its rays on-device from its row offset (no
    host->device ray shipping). Geometry + camera are replicated, so the
    backward pass psums scene-parameter gradients across devices — XLA
    inserts and overlaps the collectives.
  * frames       -> "frames" mesh axis: animation keyframes batched across
    a second mesh dimension (the reference renders frames serially,
    include/anim.cpp:82).

Stats are psum'd over the mesh so every shard returns the global counts
(the reference's OpenMP reduction at render.hpp:104).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ceres_tpu.models.camera import (Camera, camera_rays,
                                     camera_rays_rows)
from ceres_tpu.models.mesh import triangle_soup
from ceres_tpu.models.transform import Transform
from ceres_tpu.render.renderer import RenderConfig, render_wavefront


def device_mesh(
    num_frames_axis: int = 1, devices=None
) -> Mesh:
    """A ("frames", "rays") mesh over the available devices.

    With ``num_frames_axis=1`` this is the pure ray-sharded (data-parallel)
    mesh; larger values split devices between frame-batching and
    ray-sharding.
    """
    import numpy as np

    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n % num_frames_axis:
        raise ValueError(f"{n} devices not divisible by frames axis "
                         f"{num_frames_axis}")
    return Mesh(devices.reshape(num_frames_axis, n // num_frames_axis),
                ("frames", "rays"))


def _pad_rows(height: int, n_shards: int) -> int:
    return -(-height // n_shards)


def _as_spheres(spheres, dtype):
    """Normalize an optional (centers, radii) pair to device arrays."""
    if spheres is None:
        return None
    centers, radii = spheres
    return (jnp.asarray(centers, dtype).reshape(-1, 3),
            jnp.asarray(radii, dtype).reshape(-1))


def _render_rows(verts, faces, camera, sun, row0, h_local, config,
                 soup=None, clusters=None, spheres=None, table_cols=None):
    """Render ``h_local`` image rows starting at row0 (traced scalar)."""
    if soup is None:
        soup = triangle_soup(verts, faces,
                             with_normals=config.mode == "smooth")
    dirs_hw = camera_rays_rows(camera, config.width, config.height,
                               row0, h_local)
    # The last shard's rows past the image bottom are padding: zero
    # directions make them inert (no hit), and they are not counted.
    live = (row0 + jnp.arange(h_local, dtype=dirs_hw.dtype)) < config.height
    dirs_hw = jnp.where(live[:, None, None], dirs_hw, 0.0)
    n_live = jnp.sum(live) * config.width
    if config.backend == "megakernel":
        # Pixel-block ray order (ceres_tpu.utils.tiling): raster-order
        # 512-ray tiles span most of a scanline and overlap many
        # clusters; compact blocks cull far more.
        from ceres_tpu.utils import tiling

        dirs = tiling.swizzle(dirs_hw)
        color, stats = render_wavefront(soup, camera, sun, dirs, config,
                                        clusters=clusters, spheres=spheres,
                                        table_cols=table_cols)
        color = tiling.unswizzle(color, h_local, config.width)
        stats["rays"] = stats["rays"] - (dirs.shape[0] - n_live)
        return color, stats
    dirs = dirs_hw.reshape(-1, 3)
    color, stats = render_wavefront(soup, camera, sun, dirs, config,
                                    clusters=clusters, spheres=spheres)
    stats["rays"] = stats["rays"] - (dirs.shape[0] - n_live)
    return color.reshape(h_local, config.width, 3), stats


def _global_arrays(mesh, row0_np, replicated):
    """Promote shard_map inputs to GLOBAL arrays for multi-process meshes.

    Single-process meshes accept host-local arrays directly; a mesh that
    spans processes (multi-host) needs the row-offset input materialized
    as a global array (each process contributes its addressable shards)
    and the replicated inputs device_put with an explicit replicated
    sharding. No-op on single-process runs.
    """
    import numpy as np
    from jax.sharding import NamedSharding

    tracing = any(isinstance(x, jax.core.Tracer)
                  for x in jax.tree.leaves(replicated))
    if jax.process_count() == 1 or tracing:
        # Inside a jit trace everything is already a global SPMD value;
        # materializing concrete global arrays there would close over
        # non-addressable data. Only EAGER multi-process calls need the
        # explicit promotion.
        return jnp.asarray(row0_np), replicated
    sh = NamedSharding(mesh, P("rays"))
    row0 = jax.make_array_from_callback(
        row0_np.shape, sh, lambda idx: np.ascontiguousarray(row0_np[idx]))
    rep = NamedSharding(mesh, P())
    replicated = jax.tree.map(lambda x: jax.device_put(x, rep), replicated)
    return row0, replicated


def _render_sharded_jit(vertices, faces, camera, sun, config, mesh,
                        spheres=None):
    import numpy as np

    n = mesh.shape["rays"]
    h_local = _pad_rows(config.height, n)
    row0_np = (np.arange(n) * h_local).astype(vertices.dtype)
    row0, (vertices, faces, camera, sun, spheres) = _global_arrays(
        mesh, row0_np, (vertices, faces, camera, sun, spheres))

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("rays"), P()),
        out_specs=(P("rays"), P()),
        # No vma checking: the walk kernel's pallas_call declares its
        # outputs without varying-axis types, compiled or interpreted
        # (and the cluster build's loops start from unvarying carries).
        check_vma=False,
    )
    def fn(verts, faces_, cam, sun_, row0_shard, sph):
        # Spheres are replicated like the mesh: the dense per-shard pair
        # test costs O(rows_local x S) (sphere.hpp:13-61 semantics).
        color, stats = _render_rows(verts, faces_, cam, sun_,
                                    row0_shard[0], h_local, config,
                                    spheres=sph)
        # Rows are split over "rays" only: every "frames" replica holds
        # the same image, so the counts are summed over "rays" alone.
        stats = jax.tree.map(lambda x: jax.lax.psum(x, "rays"), stats)
        return color, stats

    image, stats = fn(vertices, faces, camera, sun, row0, spheres)
    return image[:config.height], stats


def render_sharded(
    vertices,
    faces,
    camera: Camera,
    sun_position,
    config: Optional[RenderConfig] = None,
    mesh: Optional[Mesh] = None,
    spheres=None,
    **kwargs,
):
    """Multi-chip render: rows sharded over the mesh's "rays" axis.

    Drop-in equivalent of ceres_tpu.render.renderer.render — same image,
    same stats — with the wavefront split across chips. Differentiable:
    grads of replicated inputs (vertices, camera, sun) are psum'd across
    the mesh by shard_map's transpose. ``spheres`` ((S, 3) centers,
    (S,) radii) are replicated across shards like the mesh.
    """
    import dataclasses

    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    if mesh is None:
        mesh = device_mesh()
    vertices = jnp.asarray(vertices)
    faces = jnp.asarray(faces)
    sun_position = jnp.asarray(sun_position, vertices.dtype)
    spheres = _as_spheres(spheres, vertices.dtype)
    return _render_sharded_jit(vertices, faces, camera, sun_position,
                               config, mesh, spheres)


@functools.partial(jax.jit, static_argnames=("config", "mesh", "num_frames"))
def _render_frames_jit(vertices, faces, camera, sun, frame_transforms,
                       config, mesh, num_frames, spheres=None,
                       clusters_pre=None):
    """Animation frames over the "frames" axis x rows over "rays"."""
    nf = mesh.shape["frames"]
    nr = mesh.shape["rays"]
    if num_frames % nf:
        raise ValueError(f"{num_frames} frames not divisible by mesh "
                         f"frames axis {nf}")
    h_local = _pad_rows(config.height, nr)
    row0 = jnp.arange(nr, dtype=vertices.dtype) * h_local

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("frames"), P("rays"), P(), P()),
        out_specs=(P("frames", "rays"), P()),
        # No vma checking: the walk kernel's pallas_call declares its
        # outputs without varying-axis types, compiled or interpreted
        # (and the cluster build's loops start from unvarying carries).
        check_vma=False,
    )
    def fn(verts, faces_, cam, sun_, tf_shard, row0_shard, sph, cs_pre):
        # Geometry is static across frames: build the soup and the
        # traversal clusters ONCE outside the frame loop (XLA does not
        # hoist the LBVH build out of lax.map on its own).
        soup = triangle_soup(verts, faces_,
                             with_normals=config.mode == "smooth")
        clusters = None
        table = None
        if config.backend == "megakernel":
            from ceres_tpu.accel import clusters as cl
            from ceres_tpu.render.renderer import prepare_winner_table

            # Prebuilt (quality-cut) clusters when given; otherwise the
            # jittable on-device treelet build, hoisted before the frame
            # loop.
            clusters = cs_pre if cs_pre is not None else \
                cl.build_clusters_treelet(
                    jax.tree.map(jax.lax.stop_gradient, soup))
            # The winner table is frame-invariant too (static geometry);
            # XLA does not hoist it out of lax.map on its own.
            table = prepare_winner_table(soup, clusters, config)

        def one_frame(tf):
            # Per-frame rigid transform applied to camera + sun (the
            # turntable of anim.cpp:87-89 generalized to any keyframe
            # track). Spheres are scene geometry: static, like the mesh.
            cam_f = Camera(eye=tf(cam.eye),
                           dir=jnp.matmul(tf.a, cam.dir,
                                          precision=jax.lax.Precision.HIGHEST),
                           up=cam.up, fov=cam.fov)
            sun_f = tf(sun_)
            color, stats = _render_rows(verts, faces_, cam_f, sun_f,
                                        row0_shard[0], h_local, config,
                                        soup=soup, clusters=clusters,
                                        spheres=sph, table_cols=table)
            return color, stats

        colors, stats = jax.lax.map(one_frame, tf_shard)
        stats = jax.tree.map(
            lambda x: jax.lax.psum(jnp.sum(x), ("frames", "rays")), stats)
        return colors, stats

    frames, stats = fn(vertices, faces, camera, sun, frame_transforms, row0,
                       spheres, clusters_pre)
    return frames[:, :config.height], stats


def render_frames_sharded(
    vertices,
    faces,
    camera: Camera,
    sun_position,
    frame_transforms: Transform,  # stacked pytree, leading dim = num_frames
    config: Optional[RenderConfig] = None,
    mesh: Optional[Mesh] = None,
    spheres=None,
    clusters=None,
    **kwargs,
):
    """Batched multi-frame render (BASELINE config 5).

    ``frame_transforms`` is a Transform pytree whose leaves have a leading
    frame axis (e.g. from turntable_transforms); frames shard over the
    "frames" mesh axis, rows over "rays". ``spheres`` are static scene
    geometry, replicated like the mesh. Returns ((F, H, W, 3), stats).
    """
    import dataclasses

    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    if mesh is None:
        mesh = device_mesh()
    num_frames = jax.tree.leaves(frame_transforms)[0].shape[0]
    vertices = jnp.asarray(vertices)
    faces = jnp.asarray(faces)
    sun_position = jnp.asarray(sun_position, vertices.dtype)
    spheres = _as_spheres(spheres, vertices.dtype)
    return _render_frames_jit(vertices, faces, camera, sun_position,
                              frame_transforms, config, mesh, num_frames,
                              spheres, clusters)


@functools.partial(jax.jit, static_argnames=("config", "mesh", "refit"))
def _render_deforming_jit(vertices_frames, faces, camera, sun, config, mesh,
                          refit, spheres=None):
    """Per-frame DEFORMING vertices; frames sequential, rows over "rays"."""
    nr = mesh.shape["rays"]
    h_local = _pad_rows(config.height, nr)
    row0 = jnp.arange(nr, dtype=vertices_frames.dtype) * h_local

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("rays"), P()),
        out_specs=(P(None, "rays"), P()),
        # No vma checking: the walk kernel's pallas_call declares its
        # outputs without varying-axis types, compiled or interpreted
        # (and the cluster build's loops start from unvarying carries).
        check_vma=False,
    )
    def fn(vframes, faces_, cam, sun_, row0_shard, sph):
        from ceres_tpu.accel import clusters as cl

        # The treelet CUT is built once, on frame 0; every later frame
        # only REFITS it to the moved vertices (record gather + segmented
        # box min/max) — the HierarchyRefitter capability
        # (hierarchy_refitter.hpp:10-46) instead of a per-frame rebuild.
        soup0 = triangle_soup(vframes[0], faces_,
                              with_normals=config.mode == "smooth")
        cs0 = cl.build_clusters_treelet(
            jax.tree.map(jax.lax.stop_gradient, soup0))

        def one_frame(verts_f):
            soup_f = triangle_soup(verts_f, faces_,
                                   with_normals=config.mode == "smooth")
            if refit:
                cs_f = cl.refit_clusters(
                    cs0, jax.tree.map(jax.lax.stop_gradient, soup_f))
            else:
                cs_f = cl.build_clusters_treelet(
                    jax.tree.map(jax.lax.stop_gradient, soup_f))
            return _render_rows(verts_f, faces_, cam, sun_, row0_shard[0],
                                h_local, config, soup=soup_f,
                                clusters=cs_f, spheres=sph)

        colors, stats = jax.lax.map(one_frame, vframes)
        # Frames run in sequence on every shard; rows split over "rays".
        stats = jax.tree.map(lambda x: jax.lax.psum(jnp.sum(x), "rays"),
                             stats)
        return colors, stats

    frames, stats = fn(vertices_frames, faces, camera, sun, row0, spheres)
    return frames[:, :config.height], stats


def render_deforming_frames(
    vertices_frames,          # (F, V, 3): per-frame vertex positions
    faces,
    camera: Camera,
    sun_position,
    config: Optional[RenderConfig] = None,
    mesh: Optional[Mesh] = None,
    refit: bool = True,
    spheres=None,
    **kwargs,
):
    """Animation with DEFORMING geometry: per-frame vertex tracks.

    The acceleration structure's treelet cut is built once on frame 0 and
    refitted per frame (``refit=True``, the fast path — boxes stay exact
    bounds, only their tightness degrades with large deformations);
    ``refit=False`` rebuilds per frame for comparison. Rays shard over the
    mesh's "rays" axis. Returns ((F, H, W, 3), stats).
    """
    import dataclasses

    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    if mesh is None:
        mesh = device_mesh()
    vertices_frames = jnp.asarray(vertices_frames)
    faces = jnp.asarray(faces)
    sun_position = jnp.asarray(sun_position, vertices_frames.dtype)
    if config.backend != "megakernel":
        raise ValueError("render_deforming_frames requires the megakernel "
                         "backend (the refit path refits its clusters)")
    spheres = _as_spheres(spheres, vertices_frames.dtype)
    return _render_deforming_jit(vertices_frames, faces, camera,
                                 sun_position, config, mesh, refit, spheres)


def turntable_transforms(num_frames: int, axis=(0.0, 1.0, 0.0),
                         dtype=jnp.float32) -> Transform:
    """The anim app's camera path: frame i rotates by i * 360/N degrees
    about ``axis`` (include/anim.cpp:77-89), as a stacked Transform."""
    angles = (jnp.arange(num_frames, dtype=dtype)
              * (2.0 * jnp.pi / num_frames))
    axis = jnp.asarray(axis, dtype)

    def make(angle):
        return Transform.identity(dtype).rotate(axis, angle)

    return jax.vmap(make)(angles)


# ---------------------------------------------------------------------------
# Primitive sharding (the TP-analog): geometry split across chips
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def _render_prim_sharded_jit(vertices, faces, vn, camera, sun, config, mesh,
                             spheres=None):
    from ceres_tpu.models.mesh import TriangleSoup
    from ceres_tpu.models import shading as shading_mod
    from ceres_tpu.render.renderer import (
        SELF_INTERSECT_OFFSET, _any_shadow, _closest_primary, _normalize)
    from ceres_tpu.utils import tiling

    n = mesh.shape["rays"] * mesh.shape["frames"]
    flat = Mesh(mesh.devices.reshape(-1), ("prims",))
    F = faces.shape[0]
    pad = (-F) % n
    # Zero-padded faces are degenerate (p0 = p1 = p2 -> n = 0 -> det = 0):
    # the NaN-safe Möller-Trumbore accept rejects them on every shard.
    faces_p = jnp.pad(faces, ((0, pad), (0, 0)))

    dirs_hw = camera_rays(camera, config.width, config.height)
    dirs = tiling.swizzle(dirs_hw) if config.backend == "megakernel" \
        else dirs_hw.reshape(-1, 3)
    R = dirs.shape[0]

    @functools.partial(
        jax.shard_map,
        mesh=flat,
        in_specs=(P(), P("prims"), P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
        # No vma checking: the walk kernel's pallas_call declares its
        # outputs without varying-axis types, compiled or interpreted
        # (and the cluster build's loops start from unvarying carries).
        check_vma=False,
    )
    def fn(verts, faces_shard, vn_, cam, sun_, dirs_, sph):
        ax = jax.lax.axis_index("prims")
        p0 = verts[faces_shard[:, 0]]
        p1 = verts[faces_shard[:, 1]]
        p2 = verts[faces_shard[:, 2]]
        e1 = p0 - p1
        e2 = p2 - p0
        nrm = jnp.cross(e1, e2)
        soup = TriangleSoup(p0=p0, e1=e1, e2=e2, n=nrm,
                            corner_normals=vn_[faces_shard])

        hit = _closest_primary(soup, cam, dirs_, config.backend)
        t_local = jnp.where(hit.mask, hit.t, jnp.inf)
        # Hit-distance min-combine across primitive shards (the TP-analog
        # reduction, SURVEY.md §2: "each chip intersects its primitive
        # shard, pmin over hit distance").
        t_min = jax.lax.pmin(t_local, "prims")
        hit_tri = jnp.isfinite(t_min)
        hit_any = hit_tri
        # Winner shard per ray, lowest shard id breaking exact-t ties so
        # the shading sum counts each ray exactly once.
        mine = hit.mask & (t_local == t_min)
        win_ax = jax.lax.pmin(jnp.where(mine, ax, n), "prims")
        winner = mine & (ax == win_ax)

        sph_win = jnp.zeros((R,), bool)
        if sph is not None:
            # Spheres are replicated: every shard computes the identical
            # dense pair test (sphere.hpp:13-61), the closest-t merge
            # happens AGAINST the cross-shard t_min, and a sphere win
            # clears the triangle winner so the shading psum contributes
            # zero there (the sphere shade is added replicated, below).
            from ceres_tpu.ops import sphere as sphere_ops

            centers, radii = sph
            origins = jnp.broadcast_to(cam.eye, dirs_.shape)
            s_hit = sphere_ops.closest_hit(origins, dirs_, centers, radii)
            sph_win = s_hit.mask & (s_hit.t < t_min)
            hit_any = hit_tri | s_hit.mask
            winner = winner & ~sph_win

        prim = jnp.where(winner, hit.prim_id, 0)
        rec_n = jnp.where(winner[:, None], soup.n[prim], 0.0)
        n_glob = jax.lax.psum(rec_n, "prims")
        tri_pt = hit_tri & ~sph_win
        point = cam.eye + jnp.where(tri_pt, t_min, 0.0)[:, None] * dirs_
        point = point + SELF_INTERSECT_OFFSET * _normalize(
            jnp.where(tri_pt[:, None], n_glob, 1.0))
        if sph is not None:
            st_safe = jnp.where(sph_win, s_hit.t, 0.0)
            s_point = cam.eye + st_safe[:, None] * dirs_
            s_nrm = sphere_ops.normal_at(s_point, centers, s_hit.sphere_id)
            point = jnp.where(sph_win[:, None],
                              s_point - SELF_INTERSECT_OFFSET * s_nrm,
                              point)
        sun_line = _normalize(sun_[None, :] - point)

        if config.shadows:
            occ_local = _any_shadow(soup, point, sun_line, config.backend,
                                    skip=~hit_any)
            occluded = jax.lax.psum(occ_local.astype(jnp.int32), "prims") > 0
            if sph is not None:
                # Spheres occlude too (replicated, identical per shard).
                dist = jnp.linalg.norm(sun_[None, :] - point, axis=-1)
                occ_s = sphere_ops.any_hit(point, sun_line, centers, radii,
                                           tmax=(dist * (1.0 - 1e-4))[:, None])
                occluded = occluded | (occ_s & hit_any)
        else:
            occluded = jnp.zeros((R,), bool)

        if config.mode == "smooth":
            shade_l = shading_mod.smooth_shading(
                sun_line, soup.corner_normals[prim], dirs_, hit.u, hit.v)
        elif config.mode in ("flat", "normal"):
            shade_l = shading_mod.flat_shading(soup.n[prim])
            if config.mode == "normal":
                occluded = jnp.zeros_like(occluded)
        else:
            raise ValueError(f"unknown shading mode: {config.mode}")
        shade = jax.lax.psum(jnp.where(winner[:, None], shade_l, 0.0),
                             "prims")
        if sph is not None:
            # Sphere shade: exact normal on all three Gouraud "corners"
            # (degenerates to per-pixel normal shading), replicated so no
            # psum is involved.
            if config.mode == "smooth":
                zero = jnp.zeros((R,), dirs_.dtype)
                s_corners = jnp.broadcast_to(s_nrm[:, None, :], (R, 3, 3))
                shade_s = shading_mod.smooth_shading(
                    sun_line, s_corners, dirs_, zero, zero)
            else:
                shade_s = shading_mod.flat_shading(s_nrm)
            shade = jnp.where(sph_win[:, None], shade_s, shade)

        lit = hit_any & ~occluded
        color = jnp.where(lit[:, None], shade, 0.0)
        primary_hits = jnp.sum(hit_any)
        shadow_hits = jnp.sum(hit_any & occluded)
        stats = {"rays": dirs_.shape[0] + primary_hits,
                 "hits": primary_hits + shadow_hits,
                 "primary_hits": primary_hits,
                 "shadow_hits": shadow_hits}
        return color, stats

    color, stats = fn(vertices, faces_p, vn, camera, sun, dirs, spheres)
    if config.backend == "megakernel":
        image = tiling.unswizzle(color, config.height, config.width)
        stats["rays"] = stats["rays"] - (R - config.height * config.width)
    else:
        image = color.reshape(config.height, config.width, 3)
    return image, stats


def render_primitive_sharded(
    vertices,
    faces,
    camera: Camera,
    sun_position,
    config: Optional[RenderConfig] = None,
    mesh: Optional[Mesh] = None,
    spheres=None,
    **kwargs,
):
    """Primitive-sharded render: GEOMETRY split across chips, rays replicated.

    The TP-analog for scenes exceeding one chip's memory (SURVEY.md §2
    parallelism table / BASELINE north star: "mesh geometry replicated or
    primitive-sharded"): each chip holds 1/N of the triangles, intersects
    the full wavefront against its shard, and the closest hit is combined
    with an all-reduce-min on hit distance; occlusion ORs across shards;
    the winning shard contributes the shading. Same image as
    renderer.render up to exact-distance tie-breaks.

    Vertex normals are computed from the FULL mesh before sharding (the
    area-weighted accumulation needs every incident face). ``spheres``
    ((S, 3) centers, (S,) radii) are replicated — the dense pair test is
    tiny next to any shard's triangle work.
    """
    import dataclasses

    from ceres_tpu.models.mesh import vertex_normals

    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    if mesh is None:
        mesh = device_mesh()
    vertices = jnp.asarray(vertices)
    faces = jnp.asarray(faces)
    sun_position = jnp.asarray(sun_position, vertices.dtype)
    vn = vertex_normals(vertices, faces)
    spheres = _as_spheres(spheres, vertices.dtype)
    return _render_prim_sharded_jit(vertices, faces, vn, camera,
                                    sun_position, config, mesh, spheres)
