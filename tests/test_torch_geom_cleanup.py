"""The port's point-cloud cleanup and nearest-neighbour queries
(``dropclip_tpu_torch.geom.{cleanup,knn}``) against the JAX package's on
the CPU, same numpy inputs from a seed: ``voxel_pool``, ``pc_voxel_down``,
``find_closest_indices`` and ``nearest_neighbor_device`` equal;
``remove_stat_outlier`` and ``pc_outlier_removal`` keep the same indices;
the RANSAC plane (other random draws, the same distribution) within
tolerance of the JAX fit and of the true plane."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dropclip_tpu.geom import cleanup as jclean
from dropclip_tpu.geom import knn as jknn
from dropclip_tpu_torch.geom import cleanup, knn


def _plane_plus_blob(seed, n_plane=2000, n_blob=300):
    rng = np.random.default_rng(seed)
    plane = np.stack([rng.uniform(-1, 1, n_plane),
                      rng.uniform(-1, 1, n_plane),
                      rng.normal(0, 0.002, n_plane)], axis=1)
    blob = rng.normal(0, 0.05, (n_blob, 3)) + np.array([0.2, 0.1, 0.3])
    return np.concatenate([plane, blob]).astype(np.float32)


@pytest.mark.parametrize("seed,repeat", [(0, 1), (1, 1), (2, 9)])
def test_voxel_pool_equal(seed, repeat):
    """Bit-equal to the JAX pool (float64 sums in input order), also for
    the 9-view duplicates of REGRAD ingest and payloads whose magnitudes
    span six decades."""
    rng = np.random.default_rng(seed)
    xyz = np.repeat(rng.uniform(-0.3, 0.3, (4000 // repeat, 3)), repeat, 0)
    xyz = (xyz + rng.normal(0, 0.002, xyz.shape)).astype(np.float32)
    n = len(xyz)
    pay = {"rgb": rng.random((n, 3)).astype(np.float32),
           "mv": (rng.standard_normal((n, 16)) * 10 ** rng.uniform(
               -3, 3, (n, 1))).astype(np.float32)}
    lab = rng.integers(1, 6, n)
    got = cleanup.voxel_pool(xyz, pay, lab, voxel_size=0.05)
    ref = jclean.voxel_pool(xyz, pay, lab, voxel_size=0.05)
    np.testing.assert_array_equal(got[0], ref[0])
    for k in pay:
        np.testing.assert_array_equal(got[1][k], ref[1][k])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(cleanup.pc_voxel_down(xyz, 0.1),
                                  jclean.pc_voxel_down(xyz, 0.1))
    empty = cleanup.voxel_pool(xyz, None, None, 0.1)
    assert empty[1] == {} and empty[2] is None


@pytest.mark.parametrize("chunk", [64, 2048])
def test_nearest_neighbours_equal(chunk):
    rng = np.random.default_rng(3)
    src = rng.standard_normal((700, 3)).astype(np.float32)
    tgt = rng.standard_normal((300, 3)).astype(np.float32)
    ref = jknn.find_closest_indices(src, tgt)
    np.testing.assert_array_equal(knn.find_closest_indices(src, tgt), ref)
    got = knn.nearest_neighbor_device(torch.from_numpy(src), tgt,
                                      chunk=chunk)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jknn.nearest_neighbor_device(src, tgt)))
    assert knn.nearest_neighbor_device(src, tgt[:0]).shape == (0,)


def test_outlier_filters_keep_the_same_points():
    rng = np.random.default_rng(4)
    dense = rng.normal(0, 0.05, (1000, 3)).astype(np.float32)
    far = np.array([[5.0, 5, 5], [-6, 0, 2], [0, 8, -3]], np.float32)
    pts = np.concatenate([dense, far])
    kept, ind = cleanup.remove_stat_outlier(pts, n_pts=25, ratio=2.0,
                                            device="cpu")
    jkept, jind = jclean.remove_stat_outlier(pts, n_pts=25, ratio=2.0)
    np.testing.assert_array_equal(ind, jind)
    np.testing.assert_array_equal(kept, jkept)
    assert not set(range(1000, 1003)) & set(ind.tolist())
    md = cleanup._knn_mean_dist(torch.from_numpy(pts),
                                torch.ones(len(pts), dtype=torch.bool), 25,
                                chunk=256).numpy()
    jmd = np.asarray(jclean._knn_mean_dist(jnp.asarray(pts),
                                           jnp.ones(len(pts), bool), 25))
    np.testing.assert_allclose(md, jmd, rtol=1e-5, atol=1e-6)

    blob = np.concatenate([rng.normal(0, 0.02, (2000, 3)),
                           rng.normal(0, 0.01, (5, 3)) + 3.0]
                          ).astype(np.float32)
    got = cleanup.pc_outlier_removal(blob, eps=0.05, min_points=15,
                                     voxel_size=0.02, device="cpu")
    np.testing.assert_array_equal(got, jclean.pc_outlier_removal(
        blob, eps=0.05, min_points=15, voxel_size=0.02))
    assert cleanup.remove_stat_outlier(pts[:1], device="cpu")[1].tolist() \
        == [0]


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_plane_within_tolerance(seed):
    """Torch's draws are not JAX's, so the models are compared, not the
    triples: both normals within 0.05 of the true +-z (and of each other,
    up to sign), offsets within 0.02, inlier sets agreeing on 98% of the
    points; the validity mask honoured; ``plane_removal`` keeps the blob
    (the same 250-450 points as the JAX test asks)."""
    pts = _plane_plus_blob(seed)
    t = torch.from_numpy(pts)
    gen = torch.Generator().manual_seed(seed)
    model, inlier = cleanup.segment_plane(
        t, torch.ones(len(pts), dtype=torch.bool), 0.01, generator=gen)
    jmodel, jinlier = jclean.segment_plane(jnp.asarray(pts),
                                           jnp.ones(len(pts), bool), 0.01)
    model, jmodel = model.numpy(), np.asarray(jmodel)
    sign = np.sign(model[2] * jmodel[2])
    assert abs(abs(model[2]) - 1.0) < 0.05 and abs(model[3]) < 0.02
    np.testing.assert_allclose(model * sign, jmodel, atol=0.05)
    inlier = inlier.numpy()
    assert (inlier == np.asarray(jinlier)).mean() > 0.98
    assert inlier[:2000].mean() > 0.98 and inlier[2000:].mean() < 0.1

    mask = torch.ones(len(pts), dtype=torch.bool)
    mask[:2000] = False
    _, inl = cleanup.segment_plane(t, mask, 0.01, generator=gen)
    assert not inl[:2000].any()

    kept = cleanup.plane_removal(pts, 0.01, device="cpu", seed=seed)
    jkept = jclean.plane_removal(pts, 0.01)
    assert 250 <= len(kept) <= 450 and abs(len(kept) - len(jkept)) <= 40
    assert np.linalg.norm(kept.mean(0) - [0.2, 0.1, 0.3]) < 0.05
