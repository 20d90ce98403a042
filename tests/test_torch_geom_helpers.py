"""The geometry helpers of the port against the JAX package on the same
numpy inputs: ``geom.voxelize.sparse_quantize`` and ``unravel_key``, the
projection helpers (``reconstruct_feature_map``, ``bicubic_upsample``,
``project_2d_features_to_3d``, ``pool_multiview_features``), the pose
transforms and ``CoordTransform2d``, ``geom.camera.CameraIntrinsics``, and
``similarity.paired_softmax_probs``.

Tolerances: integer results and host numpy functions are held equal;
float32 results within 1e-6 (pose products, point unprojection, softmax
probabilities, where both sides compute in float32 in another summation
order) and 1e-5 for the bicubic upsample (16 taps summed separably in
another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu import similarity as jsim
from dropclip_tpu.geom import camera as jcam
from dropclip_tpu.geom import projections as jproj
from dropclip_tpu.geom import transforms as jtr
from dropclip_tpu.geom import voxelize as jvox
from dropclip_tpu_torch import geom as tgeom
from dropclip_tpu_torch import similarity as tsim
from dropclip_tpu_torch.geom import camera as tcam
from dropclip_tpu_torch.geom import projections as tproj
from dropclip_tpu_torch.geom import transforms as ttr
from dropclip_tpu_torch.geom import voxelize as tvox

FIELDS = ("coords", "mask", "unique_idx", "inverse_map", "labels",
          "num_voxels", "overflowed")


def _poses(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        T = np.eye(4)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.randn(3)
        out.append(T)
    return np.stack(out).astype(np.float32)


def _same_voxelized(got, ref):
    for name in FIELDS:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=name)


def _both(xyz, voxel, cap, **kw):
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    return (tvox.sparse_quantize(torch.as_tensor(xyz), voxel, cap, **tkw),
            jvox.sparse_quantize(jnp.asarray(xyz), voxel, cap, **jkw))


@pytest.mark.parametrize("case", ["plain", "labels", "conflict", "valid",
                                  "overflow", "out_of_range", "bits8"])
def test_sparse_quantize_matches_jax(case):
    """The cases of tests/test_voxelize.py: every field equal."""
    rng = np.random.RandomState(3)
    xyz = (rng.rand(500, 3) * 2 - 1).astype(np.float32)
    labels = rng.randint(0, 5, 500).astype(np.int32)
    kw, voxel, cap = {}, 0.1, 1024
    if case == "labels":
        kw = dict(labels=labels, ignore_label=-1)
    elif case == "conflict":
        xyz = np.array([[0.01, 0.01, 0.01], [0.02, 0.02, 0.02],
                        [0.5, 0.5, 0.5]], np.float32)
        kw, cap = dict(labels=np.array([1, 2, 3], np.int32)), 8
    elif case == "valid":
        kw, voxel, cap = dict(valid=rng.rand(500) < 0.3,
                              labels=labels), 0.002, 256
    elif case == "overflow":
        kw, voxel, cap = dict(labels=labels), 0.002, 16
    elif case == "out_of_range":
        xyz[::7] *= 1000.0  # past the 10-bit grid
        kw = dict(labels=labels)
    elif case == "bits8":
        kw = dict(bits=8, labels=labels)
    got, ref = _both(xyz, voxel, cap, **kw)
    _same_voxelized(got, ref)
    if case == "conflict":
        n = int(got.num_voxels)
        assert n == 2 and sorted(got.labels[:n].tolist()) == [0, 3]
    if case == "overflow":
        assert bool(got.overflowed) and int(got.num_voxels) == 16
    if case == "out_of_range":
        assert (got.inverse_map.numpy()[::7] == -1).all()


def test_sparse_quantize_batched_matches_jax_vmap():
    """Leading batch axes against ``jax.vmap`` of the JAX function, with
    per-scene labels and valid masks; each scene also equals its own
    call."""
    rng = np.random.RandomState(4)
    xyz = rng.rand(4, 300, 3).astype(np.float32)
    valid = rng.rand(4, 300) < 0.8
    labels = rng.randint(0, 3, (4, 300)).astype(np.int32)
    ref = jax.vmap(lambda x, v, l: jvox.sparse_quantize(
        x, 0.05, 256, valid=v, labels=l))(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(labels))
    got = tvox.sparse_quantize(torch.as_tensor(xyz), 0.05, 256,
                               valid=torch.as_tensor(valid),
                               labels=torch.as_tensor(labels))
    _same_voxelized(got, ref)
    one = tvox.sparse_quantize(torch.as_tensor(xyz[2]), 0.05, 256,
                               valid=torch.as_tensor(valid[2]),
                               labels=torch.as_tensor(labels[2]))
    for name in FIELDS:
        assert torch.equal(getattr(one, name), getattr(got, name)[2]), name


def test_unravel_key_round_trip():
    """``unravel_key`` inverts ``ravel_grid_coords`` and equals the JAX
    function; the gather engine's topology takes the same function."""
    from dropclip_tpu_torch.sparse import topology

    grid = np.random.RandomState(0).randint(-512, 512, (1000, 3)).astype(
        np.int32)
    keys = tvox.ravel_grid_coords(torch.as_tensor(grid))
    back = tvox.unravel_key(keys)
    np.testing.assert_array_equal(back.numpy(), grid)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jvox.unravel_key(jnp.asarray(keys.numpy()))))
    assert topology.unravel_key is tvox.unravel_key


@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_reconstruct_and_bicubic_upsample(hw):
    """Nearest upsample equal; bicubic within 1e-5 of the JAX result."""
    feat = np.random.RandomState(1).randn(6, 8, 5).astype(np.float32)
    got = tproj.reconstruct_feature_map(torch.as_tensor(feat), hw)
    ref = jproj.reconstruct_feature_map(jnp.asarray(feat), hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = tproj.bicubic_upsample(torch.as_tensor(feat), hw)
    ref = jproj.bicubic_upsample(jnp.asarray(feat), hw)
    assert got.shape == (*hw, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("crop,step,flip,pose", [
    (None, None, False, False), (20, None, False, False),
    (20, 3, True, True), (16, 2, False, True)])
def test_project_2d_features_to_3d(crop, step, flip, pose):
    """Point/feature pairs within 1e-6 of the JAX function, with the
    centre crop (the feature map cropped alongside the depth), the axis
    fix, subsampling and a camera pose."""
    rng = np.random.RandomState(2)
    depth = (rng.rand(30, 40) + 0.5).astype(np.float32)
    feats = rng.randn(30, 40, 6).astype(np.float32)
    K = np.array([[50.0, 0, 19.5], [0, 52.0, 14.5], [0, 0, 1]], np.float32)
    T = _poses(1, seed=5)[0]
    jfix = (lambda p: p * jnp.asarray([1.0, -1.0, -1.0])) if flip else None
    tfix = ttr.flip_yz if flip else None
    jpc, jf = jproj.project_2d_features_to_3d(
        depth, feats, K, center_crop=crop, transform_coords=jfix,
        subsample_step=step, camera_pose=T if pose else None)
    tpc, tf = tproj.project_2d_features_to_3d(
        torch.as_tensor(depth), torch.as_tensor(feats), torch.as_tensor(K),
        center_crop=crop, transform_coords=tfix, subsample_step=step,
        camera_pose=torch.as_tensor(T) if pose else None)
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # numpy in, as the JAX function takes it
    npc, _ = tproj.project_2d_features_to_3d(depth, feats, K,
                                             center_crop=crop)
    assert npc.dtype == torch.float32


def test_pool_multiview_features():
    """Max pooling over duplicate points: equal, from numpy and tensors."""
    rng = np.random.RandomState(3)
    pc = rng.randint(0, 4, (200, 3)).astype(np.float32) * 0.01
    feats = rng.randn(200, 7).astype(np.float32)
    ju, jp = jproj.pool_multiview_features(pc, feats)
    for args in ((pc, feats), (torch.as_tensor(pc), torch.as_tensor(feats))):
        tu, tp = tproj.pool_multiview_features(*args)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tp, jp)


def test_pose_transforms_and_coord_transform():
    """Poses world <-> cam within 1e-6 and round-tripping; the six maps of
    ``CoordTransform2d`` equal, on scalars and arrays."""
    poses = _poses(6, seed=1)
    cam = _poses(1, seed=9)[0]
    for name in ("transform_poses_to_camera_frame",
                 "transform_poses_to_world_frame"):
        got = getattr(ttr, name)(torch.as_tensor(poses),
                                 torch.as_tensor(cam))
        ref = getattr(jtr, name)(jnp.asarray(poses), jnp.asarray(cam))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    back = ttr.transform_poses_to_world_frame(
        ttr.transform_poses_to_camera_frame(torch.as_tensor(poses),
                                            torch.as_tensor(cam)),
        torch.as_tensor(cam))
    np.testing.assert_allclose(back.numpy(), poses, rtol=0, atol=1e-5)

    xs = np.arange(0, 641, 7)
    ys = np.arange(0, 481, 5)
    for dims in (((480, 640), 14, (336, 448)), ((480, 640), 16, None),
                 ((333, 517), 14, (224, 224))):
        j, t = jtr.CoordTransform2d(*dims), ttr.CoordTransform2d(*dims)
        for name in ("img_to_patch", "patch_to_img", "crop_to_patch",
                     "patch_to_crop", "img_to_crop", "crop_to_img"):
            for x, y in ((xs, ys), (37, 211), (torch.as_tensor(xs),
                                               torch.as_tensor(ys))):
                jx, jy = getattr(j, name)(np.asarray(x), np.asarray(y))
                tx, ty = getattr(t, name)(x, y)
                assert tx.dtype == ty.dtype == torch.int32
                np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
                np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_camera_intrinsics():
    """``K``, ``from_dict``, ``mvtod`` and ``scale`` equal the JAX value
    object's; ``K`` is float32 on the device given (the CPU by default)."""
    d = {"fx": 600.5, "fy": 601.25, "cx": 320.0, "cy": 241.5}
    pairs = [(tcam.CameraIntrinsics.from_dict(d, 800, 600),
              jcam.CameraIntrinsics.from_dict(d, 800, 600)),
             (tcam.CameraIntrinsics.mvtod(), jcam.CameraIntrinsics.mvtod()),
             (tcam.CameraIntrinsics.mvtod(7.5),
              jcam.CameraIntrinsics.mvtod(7.5))]
    pairs.append((pairs[0][0].scale(0.5, 0.75), pairs[0][1].scale(0.5, 0.75)))
    for t, j in pairs:
        assert t.K.dtype == torch.float32 and t.K.device.type == "cpu"
        np.testing.assert_array_equal(t.K.numpy(), np.asarray(j.K))
        assert (t.fx, t.fy, t.cx, t.cy, t.width, t.height) == (
            j.fx, j.fy, j.cx, j.cy, j.width, j.height)
    assert tgeom.CameraIntrinsics is tcam.CameraIntrinsics
    assert tcam.CameraIntrinsics.mvtod(device="cpu") == \
        tcam.CameraIntrinsics.mvtod()


@pytest.mark.parametrize("masked", [False, True])
def test_paired_softmax_probs(masked):
    """Within 1e-6 of the JAX function, leading axes kept; a padded
    negative set under ``neg_mask`` equals the unpadded one."""
    rng = np.random.RandomState(6)
    norm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    vis = norm(rng.randn(2, 50, 16)).astype(np.float32)
    pos = norm(rng.randn(16)).astype(np.float32)
    negs = norm(rng.randn(6, 16)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], bool) if masked else None
    ref = jsim.paired_softmax_probs(
        jnp.asarray(vis), jnp.asarray(pos), jnp.asarray(negs),
        neg_mask=None if mask is None else jnp.asarray(mask))
    got = tsim.paired_softmax_probs(
        torch.as_tensor(vis), torch.as_tensor(pos), torch.as_tensor(negs),
        neg_mask=None if mask is None else torch.as_tensor(mask))
    assert got.shape == (2, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    if masked:
        real = tsim.paired_softmax_probs(
            torch.as_tensor(vis), torch.as_tensor(pos),
            torch.as_tensor(negs[mask]))
        np.testing.assert_allclose(got.numpy(), real.numpy(), rtol=0,
                                   atol=1e-6)
