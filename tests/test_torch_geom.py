"""Geometry: dropclip_tpu_torch.geom (transforms, projections, voxel
downsampling, multi-view aggregation) against dropclip_tpu.geom on the
same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dropclip_tpu.data.synthetic import make_raw_scene
from dropclip_tpu.geom import aggregate as jagg
from dropclip_tpu.geom import projections as jproj
from dropclip_tpu.geom import transforms as jtr
from dropclip_tpu.geom import voxelize as jvox
from dropclip_tpu_torch.geom import aggregate as tagg
from dropclip_tpu_torch.geom import projections as tproj
from dropclip_tpu_torch.geom import transforms as ttr
from dropclip_tpu_torch.geom import voxelize as tvox


def _poses(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        a, b, c, d = q
        R = np.array([[a*a+b*b-c*c-d*d, 2*(b*c-a*d), 2*(b*d+a*c)],
                      [2*(b*c+a*d), a*a-b*b+c*c-d*d, 2*(c*d-a*b)],
                      [2*(b*d-a*c), 2*(c*d+a*b), a*a-b*b-c*c+d*d]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.randn(3)
        out.append(T)
    return np.stack(out).astype(np.float32)


def test_transforms_match_jax():
    """affine_inverse, cam<->world and the y/z flip, float32 within 1e-5;
    the port batches poses over a leading axis."""
    poses = _poses(5)
    pts = np.random.RandomState(1).randn(100, 3).astype(np.float32)
    np.testing.assert_allclose(
        ttr.affine_inverse(torch.as_tensor(poses)).numpy(),
        np.asarray(jtr.affine_inverse(jnp.asarray(poses))), atol=1e-5)
    batched = ttr.transform_pointcloud_to_camera_frame(
        torch.as_tensor(pts), torch.as_tensor(poses)).numpy()
    for v in range(5):
        ref_c = np.asarray(jtr.transform_pointcloud_to_camera_frame(
            jnp.asarray(pts), jnp.asarray(poses[v])))
        np.testing.assert_allclose(batched[v], ref_c, atol=1e-5)
        ref_w = np.asarray(jtr.transform_pointcloud_to_world_frame(
            jnp.asarray(pts), jnp.asarray(poses[v])))
        np.testing.assert_allclose(
            ttr.transform_pointcloud_to_world_frame(
                torch.as_tensor(pts), torch.as_tensor(poses[v])).numpy(),
            ref_w, atol=1e-5)
    np.testing.assert_array_equal(
        ttr.flip_yz(torch.as_tensor(pts)).numpy(),
        np.asarray(jtr.flip_yz(jnp.asarray(pts))))


def test_projections_match_jax():
    rng = np.random.RandomState(2)
    K = np.array([[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]], np.float32)
    depth = rng.uniform(0.5, 3.0, (48, 64)).astype(np.float32)
    depth[::7, ::5] = 0.0
    np.testing.assert_allclose(
        tproj.depth_to_pointcloud(torch.as_tensor(depth),
                                  torch.as_tensor(K)).numpy(),
        np.asarray(jproj.depth_to_pointcloud(jnp.asarray(depth),
                                             jnp.asarray(K))), atol=1e-6)
    pts = rng.randn(200, 3).astype(np.float32)
    pts[:5, 2] = 0.0  # z == 0 rows
    np.testing.assert_allclose(
        tproj.pointcloud_to_pixel(torch.as_tensor(pts),
                                  torch.as_tensor(K)).numpy(),
        np.asarray(jproj.pointcloud_to_pixel(jnp.asarray(pts),
                                             jnp.asarray(K))), rtol=1e-6,
        atol=1e-4)
    got = tproj.project_points(torch.as_tensor(pts), torch.as_tensor(K),
                               64, 48)
    ref = jproj.project_points(jnp.asarray(pts), jnp.asarray(K), 64, 48)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_ravel_grid_coords_matches_jax():
    rng = np.random.RandomState(3)
    grid = rng.randint(-600, 600, (500, 3)).astype(np.int32)
    valid = rng.rand(500) > 0.2
    for bits in (8, 10):
        np.testing.assert_array_equal(
            tvox.ravel_grid_coords(torch.as_tensor(grid), bits,
                                   torch.as_tensor(valid)).numpy(),
            np.asarray(jvox.ravel_grid_coords(jnp.asarray(grid), bits,
                                              jnp.asarray(valid))))
    assert tvox.INVALID_KEY == int(jvox.INVALID_KEY)


def _cloud(n, seed):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    xyz[: n // 10] += 40.0  # out of the 10-bit grid at 5 cm -> dropped
    cols = rng.rand(n, 3).astype(np.float32)
    labs = rng.randint(0, 5, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    return xyz, cols, labs, valid


@pytest.mark.parametrize("capacity", [4096, 100])
def test_voxel_downsample_matches_jax(capacity):
    """Voxel means within 1e-6, labels (first maximum of the vote) and
    mask equal, and ``dropped`` counting the same points, both with room
    to spare and at capacity overflow (100 of ~500 voxels)."""
    xyz, cols, labs, valid = _cloud(3000, seed=capacity)
    ref = jvox.voxel_downsample(jnp.asarray(xyz), jnp.asarray(cols),
                                jnp.asarray(labs), 0.05, capacity, 5,
                                valid=jnp.asarray(valid))
    got = tvox.voxel_downsample(torch.as_tensor(xyz), torch.as_tensor(cols),
                                torch.as_tensor(labs), 0.05, capacity, 5,
                                valid=torch.as_tensor(valid))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4]) > 0
    if capacity == 100:
        assert bool(got[3].all())  # full


def test_voxel_downsample_chunks_the_payload(monkeypatch):
    """The payload sum in several chunks equals one chunk."""
    xyz, cols, labs, valid = _cloud(2000, seed=7)
    args = [torch.as_tensor(a) for a in (xyz, cols, labs)]
    one = tvox.voxel_downsample(*args, 0.05, 1024, 5,
                                valid=torch.as_tensor(valid))
    monkeypatch.setattr(tvox, "CHUNK", 300)
    many = tvox.voxel_downsample(*args, 0.05, 1024, 5,
                                 valid=torch.as_tensor(valid))
    for a, b in zip(one, many):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("capacity,num_labels", [(4096, 16), (64, 32)])
def test_aggregate_views_matches_jax(capacity, num_labels):
    """A make_raw_scene with depths rounded through float16 (the ingest
    wire dtype): cloud, labels, mask and dropped as in JAX."""
    raw = make_raw_scene(np.random.default_rng(0), n_objects=3, n_views=4)
    d16 = raw["depths"].astype(np.float16).astype(np.float32)
    args = (d16, raw["images"], raw["segs"], raw["poses"], raw["K"])
    ref = jagg.aggregate_views(*map(jnp.asarray, args), voxel_size=0.01,
                               capacity=capacity, num_labels=num_labels)
    got = tagg.aggregate_views(*map(torch.as_tensor, args), voxel_size=0.01,
                               capacity=capacity, num_labels=num_labels)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   atol=1e-6)
    pts = tagg.unproject_views(*map(torch.as_tensor, args))
    jpts = jagg.unproject_views(*map(jnp.asarray, args))
    for a, b in zip(pts, jpts):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   atol=1e-6)
