"""Port parity: camera model and image ops against the JAX package.

Tolerances: camera maps rtol 1e-6 (atol 1e-6 for values near 0), with
and without distortion; patch sampling and warps atol 1e-3 (the bound of
tests/test_camera_image.py between the XLA and Pallas versions; XLA on
the CPU contracts multiply-adds, torch does not); Shi-Tomasi rtol 1e-4
(the 8x8 box sums add in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import camera as jcam
from fastlivo_tpu.config import CameraConfig as JCameraConfig
from fastlivo_tpu.ops import image as jimg
from fastlivo_tpu.ops.pallas_image import patches_and_grads_pallas

from fastlivo_tpu_torch import camera as tcam
from fastlivo_tpu_torch.config import CameraConfig
from fastlivo_tpu_torch.ops import image as timg
from fastlivo_tpu_torch.ops import patches_grads

DIST = [-0.0944, 0.0947, -0.00808, 8.07e-05]


def cams(distort):
    kw = dict(width=640, height=512, fx=431.795, fy=431.550, cx=310.833,
              cy=266.986, d=DIST if distort else [0.0, 0.0, 0.0, 0.0])
    return jcam.from_config(JCameraConfig(**kw)), tcam.from_config(CameraConfig(**kw), "cpu")


def texture(H, W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = (100 + 50 * np.sin(0.21 * xx) * np.cos(0.17 * yy)
           + 20 * np.sin(0.05 * xx * yy / 7) + rng.normal(0, 3, (H, W)))
    return np.clip(img, 0, 255).astype(np.float32)


def close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("distort", [False, True])
def test_camera_maps_match_jax(distort):
    jc, tc = cams(distort)
    rng = np.random.default_rng(1)
    xyz = np.stack([rng.uniform(-1.5, 1.5, 500), rng.uniform(-1.2, 1.2, 500),
                    rng.uniform(0.5, 10.0, 500)], -1).astype(np.float32)
    xyz_t = torch.from_numpy(xyz)
    px_j = jcam.world2cam(jc, jnp.asarray(xyz))
    px_t = tcam.world2cam(tc, xyz_t)
    close(px_j, px_t, 1e-6)
    xn = xyz[:, :2] / xyz[:, 2:]
    close(jcam.distort(jc, jnp.asarray(xn)), tcam.distort(tc, torch.from_numpy(xn)), 1e-6, 1e-6)
    close(jcam.undistort(jc, jnp.asarray(xn)), tcam.undistort(tc, torch.from_numpy(xn)), 1e-6, 1e-6)
    px = np.array(px_j)
    close(jcam.cam2world(jc, jnp.asarray(px)), tcam.cam2world(tc, torch.from_numpy(px)), 1e-6, 1e-6)
    for border in (0, 40):
        np.testing.assert_array_equal(
            np.asarray(jcam.is_in_frame(jc, jnp.asarray(px), border)),
            tcam.is_in_frame(tc, torch.from_numpy(px), border).numpy())


def test_load_camera_yaml_matches_jax(tmp_path):
    p = tmp_path / "cam.yaml"
    p.write_text("cam_width: 640\ncam_height: 512\ncam_fx: 431.7\ncam_fy: 431.5\n"
                 "cam_cx: 310.8\ncam_cy: 266.9\ncam_d0: -0.09\ncam_d1: 0.09\n")
    assert tcam.load_camera_yaml(p).__dict__ == jcam.load_camera_yaml(p).__dict__


def centres(H, W, K, seed, margin):
    """Centres over the image, a quarter of them within `margin` px of a
    border (their tap grids clamp)."""
    rng = np.random.default_rng(seed)
    pc = np.stack([rng.uniform(0, W - 1, K), rng.uniform(0, H - 1, K)], 1)
    q = K // 4
    pc[:q, 0] = rng.uniform(0, margin, q)
    pc[q:2 * q, 1] = rng.uniform(H - 1 - margin, H - 1, q)
    return pc.astype(np.float32)


@pytest.mark.parametrize("P", [4, 8])
def test_patches_and_grads_plain_matches_xla_and_pallas(P):
    H, W, K = 96, 160, 40
    img = texture(H, W)
    pc = centres(H, W, K, seed=P, margin=32)
    scale = np.random.default_rng(P).choice([1, 2, 4, 8, 16], K).astype(np.int32)
    scale[:5] = [1, 2, 4, 8, 16]
    got = timg.patches_and_grads(torch.from_numpy(img), torch.from_numpy(pc),
                                 P, torch.from_numpy(scale))
    want = jimg.patches_and_grads(jnp.asarray(img), jnp.asarray(pc), P, jnp.asarray(scale))
    pallas = patches_and_grads_pallas(jnp.asarray(img), jnp.asarray(pc),
                                      jnp.asarray(scale), P, interpret=True)
    for g, w, p in zip(got, want, pallas):
        assert g.shape == (K, P, P) and g.dtype == torch.float32
        close(w, g, 0, 1e-3)
        close(p, g, 0, 1e-3)


def test_patches_and_grads_wrapper_takes_plain_on_cpu():
    img = torch.from_numpy(texture(64, 80))
    pc = torch.from_numpy(centres(64, 80, 12, seed=3, margin=8))
    before = patches_grads.patches_and_grads.launches
    got = patches_grads.patches_and_grads(img, pc, 8, 2)
    want = timg.patches_and_grads(img, pc, 8, 2)
    assert patches_grads.patches_and_grads.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="device"):
        patches_grads.patches_and_grads(img.to("meta"), pc.to("meta"), 8, 2)


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_extract_patches_and_bilinear_match_jax(scale):
    H, W = 96, 160
    img = texture(H, W, 2)
    pc = centres(H, W, 30, seed=scale, margin=10)
    close(jimg.extract_patches(jnp.asarray(img), jnp.asarray(pc), 8, scale),
          timg.extract_patches(torch.from_numpy(img), torch.from_numpy(pc), 8, scale),
          0, 1e-3)
    close(jimg.bilinear(jnp.asarray(img), jnp.asarray(pc)),
          timg.bilinear(torch.from_numpy(img), torch.from_numpy(pc)), 0, 1e-3)


@pytest.mark.parametrize("ring_dtype", ["f32", "u8"])
def test_affine_warp_patches_match_jax(ring_dtype):
    H, W, K, R = 96, 160, 24, 3
    rng = np.random.default_rng(5)
    ring = np.stack([texture(H, W, s) for s in range(R)])
    if ring_dtype == "u8":
        ring = np.round(ring).astype(np.uint8)
    slots = rng.integers(0, R, K).astype(np.int32)
    A = (np.eye(2)[None] + rng.normal(0, 0.2, (K, 2, 2))).astype(np.float32)
    px = centres(H, W, K, seed=6, margin=6)
    slevel = rng.integers(0, 3, K).astype(np.int32)
    for lvl in range(3):
        want = jimg.affine_warp_patches(jnp.asarray(ring), jnp.asarray(slots), jnp.asarray(A),
                                        jnp.asarray(px), 8, jnp.asarray(slevel), lvl)
        got = timg.affine_warp_patches(torch.from_numpy(ring), torch.from_numpy(slots),
                                       torch.from_numpy(A), torch.from_numpy(px), 8,
                                       torch.from_numpy(slevel), lvl)
        assert got.dtype == torch.float32
        close(want, got, 0, 1e-3)


def test_shi_tomasi_matches_jax():
    H, W = 96, 160
    img = texture(H, W, 7)
    pc = centres(H, W, 200, seed=8, margin=3)
    want = np.asarray(jimg.shi_tomasi(jnp.asarray(img), jnp.asarray(pc)))
    got = timg.shi_tomasi(torch.from_numpy(img), torch.from_numpy(pc)).numpy()
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)
