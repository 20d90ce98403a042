"""Visualization exports: dropclip_tpu_torch.viz against dropclip_tpu.viz
on the same numpy inputs (a seed): every .pcd export byte-equal, the PNG
grids pixel-equal, the palette and PCA colours equal (the grasp-scene
export is held in tests/test_torch_grasp.py)."""

import os

import numpy as np
import pytest

from dropclip_tpu import viz as jviz
from dropclip_tpu_torch import viz


def _scene(n=200, c=12, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    rgb = rng.random((n, 3)).astype(np.float32)
    labels = rng.integers(0, 90, n)
    feats = rng.standard_normal((n, c)).astype(np.float32)
    sims = rng.random(n).astype(np.float32)
    return xyz, rgb, labels, feats, sims


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


EXPORTS = {
    "save_pcd": lambda m, p, s: m.save_pcd(p, s[0], s[1]),
    "save_pcd_xyz": lambda m, p, s: m.save_pcd(p, s[0]),
    "heatmap": lambda m, p, s: m.export_similarity_heatmap(p, s[0], s[4],
                                                           threshold=0.5),
    "feat_scene": lambda m, p, s: m.export_feat_scene(
        p, s[0], s[1], s[2], s[3], patch_feat=s[3][:, ::-1],
        trans_factor=2.5),
    "clip_pred": lambda m, p, s: m.export_clip_pred(
        p, s[0], s[4] > 0.7, s[4], s[1], gt=s[2] % 2 == 0),
    "boxes": lambda m, p, s: m.export_boxes(p, np.stack(
        [s[0][:3].min(0), s[0][:3].max(0)])[None]),
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_pcd_exports_byte_equal(tmp_path, name):
    scene = _scene()
    paths = [str(tmp_path / f"{tag}.pcd") for tag in ("jax", "torch")]
    EXPORTS[name](jviz, paths[0], scene)
    EXPORTS[name](viz, paths[1], scene)
    assert _bytes(paths[1]) == _bytes(paths[0])
    xyz, col = viz.load_pcd(paths[1])
    assert xyz.shape[1] == 3 and np.isfinite(xyz).all()


def test_colours_and_round_trip(tmp_path):
    xyz, rgb, labels, feats, sims = _scene()
    np.testing.assert_array_equal(viz.PALETTE, jviz.PALETTE)
    np.testing.assert_array_equal(viz.label_colors(labels),
                                  jviz.label_colors(labels))
    mask = labels % 3 > 0
    np.testing.assert_array_equal(viz.apply_pca(feats, mask=mask),
                                  jviz.apply_pca(feats, mask=mask))
    np.testing.assert_array_equal(viz.heat_colors(sims),
                                  jviz.heat_colors(sims))
    path = str(tmp_path / "a.pcd")
    viz.save_pcd(path, xyz, rgb)
    got_xyz, got_rgb = viz.load_pcd(path)
    np.testing.assert_array_equal(got_xyz, xyz)
    assert np.abs(got_rgb - rgb).max() <= 1 / 255 + 1e-7


def test_png_grids_equal(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (2, 12, 16, 3)).astype(np.uint8)
    sims = rng.random((2, 12, 16)).astype(np.float32)
    segs = rng.integers(0, 3, (2, 12, 16))
    obj_sims = rng.random((2, 2)).astype(np.float32)
    for fn, args in (
            ("export_multiview_similarity", (images, sims, "a mug")),
            ("export_multiview_similarity_obj_prior",
             (images, segs, [[1, 2], [1, 2]], obj_sims, "a mug"))):
        paths = [str(tmp_path / f"{tag}_{fn}.png") for tag in ("j", "t")]
        getattr(jviz, fn)(paths[0], *args)
        getattr(viz, fn)(paths[1], *args)
        from PIL import Image

        np.testing.assert_array_equal(np.asarray(Image.open(paths[1])),
                                      np.asarray(Image.open(paths[0])))
    grasp = [np.array([[2, 2], [10, 2], [10, 8], [2, 8]], np.float32)]
    np.testing.assert_array_equal(
        viz.draw_2d_grasps_in_image(images[0], grasp),
        jviz.draw_2d_grasps_in_image(images[0], grasp))
    assert os.path.getsize(paths[1]) > 0
