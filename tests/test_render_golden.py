"""End-to-end render vs the float64 golden oracle (BASELINE config 1/2 style)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu.models.camera import Camera
from ceres_tpu.render.renderer import RenderConfig, render
from ceres_tpu.render import scenes
from ceres_tpu.utils import golden


def _compare_images(ours: np.ndarray, gold: np.ndarray, pixel_budget=0.01, tol=2e-3):
    """f32 render vs f64 oracle: identical up to a small silhouette
    budget (pixels whose hit classification flips at triangle edges)."""
    diff = np.abs(ours - gold).max(axis=-1)
    bad = (diff > tol).mean()
    assert bad <= pixel_budget, f"{bad:.4%} pixels differ by more than {tol}"


@pytest.mark.parametrize("mode", ["smooth", "flat"])
def test_bunny_render_matches_oracle(bunny, mode):
    scene = scenes.bunny_scene()
    W = H = 64
    img, stats = render(
        scene.vertices, scene.faces, scene.camera, scene.sun,
        config=RenderConfig(width=W, height=H, mode=mode, backend="bruteforce"),
    )
    img = np.asarray(img)
    gold, gstats = golden.render_golden(
        scene.vertices, scene.faces,
        np.asarray(scene.camera.eye, np.float64),
        np.asarray(scene.camera.dir, np.float64),
        np.asarray(scene.camera.up, np.float64),
        float(scene.camera.fov), np.asarray(scene.sun, np.float64),
        W, H, mode=mode,
    )
    assert img.shape == (H, W, 3)
    _compare_images(img, gold)
    # Stats parity: primary hits should agree within the same edge budget.
    assert abs(int(stats["primary_hits"]) - gstats["hits"]) <= 0.01 * W * H
    # The image must not be trivially black (camera actually sees the bunny).
    assert gold.max() > 0.1
    assert img.max() > 0.1


def test_stats_semantics(bunny):
    scene = scenes.bunny_scene()
    W = H = 32
    _, stats = render(
        scene.vertices, scene.faces, scene.camera, scene.sun,
        config=RenderConfig(width=W, height=H, mode="smooth", backend="bruteforce"),
    )
    # rays = one primary per pixel + one shadow per primary hit (render.hpp:115,138)
    assert int(stats["rays"]) == W * H + int(stats["primary_hits"])
    assert int(stats["hits"]) == int(stats["primary_hits"]) + int(stats["shadow_hits"])


def test_render_differentiable(bunny):
    """Pixel gradients flow to vertices, camera and sun (detached visibility)."""
    import jax

    scene = scenes.bunny_scene()
    W = H = 24
    cfg = RenderConfig(width=W, height=H, mode="smooth", backend="bruteforce")

    from ceres_tpu.render.renderer import render_pipeline

    def loss(vertices, eye, sun):
        cam = Camera(eye=eye, dir=scene.camera.dir, up=scene.camera.up,
                     fov=scene.camera.fov)
        img, _ = render_pipeline(vertices, jnp.asarray(scene.faces), cam, sun, cfg)
        return jnp.sum(img**2)

    g_v, g_eye, g_sun = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(scene.vertices), scene.camera.eye, jnp.asarray(scene.sun)
    )
    for g in (g_v, g_eye, g_sun):
        assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.abs(g_v).sum()) > 0
    assert float(jnp.abs(g_eye).sum()) > 0
    assert float(jnp.abs(g_sun).sum()) > 0
