"""The port's data pipeline against the JAX package's on the same fake
processed dataset: scene files (h5 and .npz), dataset samples under the
recipe's augmentations, queries, loader order and the dataset dispatch."""

import os

import numpy as np
import pytest

from dropclip_tpu.core.config import load_cfg as j_load_cfg
from dropclip_tpu.data import queries as jqueries
from dropclip_tpu.data.dataset_blender import MVTODDataset as JDataset
from dropclip_tpu.data.loader import DataLoader as JLoader
from dropclip_tpu.data.scene_io import read_scene as j_read_scene
from dropclip_tpu.data.synthetic import \
    write_fake_processed_dataset as j_write_fake
from dropclip_tpu_torch.core.config import CfgNode, load_cfg
from dropclip_tpu_torch.data import build_dataset_for, queries
from dropclip_tpu_torch.data.dataset_blender import MVTODDataset
from dropclip_tpu_torch.data.loader import DataLoader
from dropclip_tpu_torch.data.scene_io import read_scene, write_scene
from dropclip_tpu_torch.data.synthetic import (make_objects_info,
                                               write_fake_processed_dataset)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "DistilBlender.yaml")
OVER = dict(voxel_size=0.02, voxel_capacity=512, feat_dim=16)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same scenes from one seed: written by the JAX package (h5) and
    by the port (h5 and npz)."""
    base = tmp_path_factory.mktemp("mvtod")
    out = {}
    for tag, write in (("jax", lambda r: j_write_fake(r, **KW)),
                       ("h5", lambda r: write_fake_processed_dataset(
                           r, fmt="h5", **KW)),
                       ("npz", lambda r: write_fake_processed_dataset(
                           r, fmt="npz", **KW))):
        out[tag] = str(base / tag)
        write(out[tag])
    return out


KW = dict(n_scenes=3, n_objects=3, feat_dim=16, n_views=4, seed=0)


def _cfgs(root, **kw):
    over = dict(OVER, root_dir=root, **kw)
    jc, pc = j_load_cfg(YAML), load_cfg(YAML)
    jc.update(over)
    pc.update(over)
    return jc, pc


def _scene_files(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs)


def test_written_scenes_equal_the_jax_ones(roots):
    """The port's h5 and npz writers hold the JAX writer's scenes array
    for array; read_scene reads all three the same."""
    jf, hf, nf = (_scene_files(roots[t]) for t in ("jax", "h5", "npz"))
    assert len(jf) == len(hf) == len(nf) == 6
    assert all(f.endswith(".npz") for f in nf)
    for a, b, c in zip(jf, hf, nf):
        ref = j_read_scene(a)
        for got in (read_scene(b), read_scene(c), read_scene(a)):
            for k in ("xyz", "rgb", "label", "vis_mask", "obj_feats",
                      "obj_ids"):
                x, y = getattr(got, k), getattr(ref, k)
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
            assert got.objects_info == ref.objects_info


def test_npz_write_read_round_trip(tmp_path):
    """write_scene to an .npz path and back, with the h5 file of the same
    scene beside it: equal, atomically renamed (no .tmp left)."""
    rng = np.random.default_rng(3)
    arrays = dict(xyz=rng.random((50, 3), np.float32),
                  rgb=rng.random((50, 3), np.float32),
                  label=rng.integers(0, 4, 50), vis_mask=rng.random((3, 50))
                  > 0.5, obj_feats=rng.random((4, 8), np.float32),
                  objects_info=make_objects_info(3, rng))
    for ext in ("npz", "h5py"):
        write_scene(str(tmp_path / "s" / f"a.{ext}"), **arrays)
    a, b = (read_scene(str(tmp_path / "s" / f"a.{e}"))
            for e in ("npz", "h5py"))
    assert sorted(os.listdir(tmp_path / "s")) == ["a.h5py", "a.npz"]
    for k in a._fields:
        if k == "objects_info":
            assert a.objects_info == b.objects_info == arrays["objects_info"]
        else:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_samples_equal_the_jax_dataset(roots, fmt, epoch):
    """Each train sample (the recipe's k random views, downsample,
    shift, rotation, elastic, flip and colour augmentation) equals the
    JAX dataset's on its h5 scenes, draw for draw; the val split too."""
    jc, _ = _cfgs(roots["jax"])
    _, pc = _cfgs(roots[fmt])
    for split in ("train", "test"):
        jd, pd = JDataset(jc, split), MVTODDataset(pc, split)
        assert len(jd) == len(pd) == 3 and pd.use_augm == (split == "train")
        jd.set_epoch(epoch)
        pd.set_epoch(epoch)
        for i in range(len(jd)):
            a, b = jd[i], pd[i]
            for k in ("coords", "mask", "in_feats", "targets", "labels",
                      "inverse_map", "xyz", "rgb", "raw_label", "obj_ids"):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            assert (b["scene_id"], b["view_id"], b["queries"]) == \
                (a["scene_id"], a["view_id"], a["queries"])


def test_loader_order_and_batches_equal_the_jax_loader(roots):
    """Epoch-seeded shuffles, batches and shards equal the JAX loader's;
    fixed view ids expand the items as in JAX."""
    jc, pc = _cfgs(roots["jax"], use_k_views=1, use_view_ids="0,2",
                   use_augmentation=False)
    pc.root_dir = roots["npz"]
    jd, pd = JDataset(jc, "train"), MVTODDataset(pc, "train")
    for shard in (0, 1):
        jl = JLoader(jd, 2, JDataset.collate, num_workers=2, seed=7,
                     shard_index=shard, num_shards=2)
        pl = DataLoader(pd, 2, MVTODDataset.collate, num_workers=2, seed=7,
                        shard_index=shard, num_shards=2)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) == len(pl) == 1
            for x, y in zip(jb, pb):
                assert (x["scene_id"], x["view_id"]) == (y["scene_id"],
                                                         y["view_id"])
                np.testing.assert_array_equal(x["coords"], y["coords"])


def test_queries_match_jax():
    """prepare_queries (every scenario) and find_unique_attribute on
    scenes with duplicate classes."""
    rng = np.random.default_rng(5)
    for _ in range(10):
        info = make_objects_info(8, rng)
        info[9] = dict(info[1], queries=dict(info[1]["queries"],
                                             Brand="acme"))
        for sc in queries.SCENARIOS:
            assert queries.prepare_queries(info, sc) == \
                jqueries.prepare_queries(info, sc)
        assert queries.find_unique_attribute(info) == \
            jqueries.find_unique_attribute(info)
    with pytest.raises(ValueError):
        queries.prepare_queries({}, "nope")


def test_dataset_dispatch_and_unported_options(roots, monkeypatch):
    """build_dataset_for gives (train, val, collate): the MV-TOD dataset,
    or the REGRAD dataset for a REGRAD config; use_view_clip's teacher is
    built at first use, on the card unless the caller asks for the CPU
    (tests/test_torch_blender.py holds its features)."""
    from dropclip_tpu_torch.data.dataset_regrad import RegradDistilDataset

    _, pc = _cfgs(roots["npz"])
    train, val, collate = build_dataset_for(pc)
    assert len(train) == len(val) == 3 and collate is MVTODDataset.collate
    pc.evaluate = False
    assert build_dataset_for(pc)[1] is None
    rtrain, rval, rcollate = build_dataset_for(CfgNode(dict(
        pc, dataset="DistilREGRAD", processed_dir=roots["npz"],
        evaluate=True, val_split="test")))
    assert isinstance(rtrain, RegradDistilDataset) and \
        rval.split == "test" and rcollate is RegradDistilDataset.collate
    vc = MVTODDataset(CfgNode(dict(pc, use_view_clip=True, use_k_views=0,
                                   use_view_ids="0")), "train")
    assert vc.raw_root == roots["npz"] and vc._vc_extractor is None
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vc._vc_get_extractor()
