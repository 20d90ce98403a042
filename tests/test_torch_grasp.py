"""The port's grasp modules (``dropclip_tpu_torch.grasp``,
``viz.export_grasp_scene`` and ``make_visualizations``' ``viz_query``
dumps) against the JAX package's on the CPU, same numpy inputs from a
seed: gripper meshes and their OBJ files byte-equal (marker, Franka,
Robotiq, and the procedural fallbacks), ``SceneGrasps`` filters equal,
``rank_grasps_by_query`` scores within 1e-5 of max|score| and orders equal
where scores are more than 1e-5 apart, the grasp-scene files byte-equal,
and the viz_query dumps (of one scene's features, and through
``make_visualizations.main`` on a trainer checkpoint) equal to the JAX
tool's inline steps."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dropclip_tpu import viz as jviz
from dropclip_tpu.grasp import grasps as jgrasps
from dropclip_tpu.grasp import gripper as jgripper
from dropclip_tpu.similarity import predict_from_embeddings as jpredict
from dropclip_tpu_torch import viz
from dropclip_tpu_torch.grasp import grasps, gripper
from dropclip_tpu_torch.tools import make_visualizations
from torch_cv2_stub import use_cv2

GRIPPERS = ("marker", "franka_panda", "robotiq_2f_140")
SCORE_TOL = 1e-5


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _grasps(mod, seed=0, n=20):
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, 3] = rng.randn(n, 3)
    return mod.SceneGrasps(np.arange(n), poses, rng.rand(n),
                           rng.randint(1, 4, n))


@pytest.mark.parametrize("name", GRIPPERS)
@pytest.mark.parametrize("assets", [True, False])
def test_gripper_meshes_byte_equal(name, assets, tmp_path, monkeypatch):
    """The port reads its own copy of the vendor meshes (and falls back
    to the same procedural ones): equal arrays, byte-equal OBJ files."""
    assert gripper._ASSETS.startswith(os.path.dirname(gripper.__file__))
    if not assets:
        monkeypatch.setattr(gripper, "_have_assets", lambda *n: False)
        monkeypatch.setattr(jgripper, "_have_assets", lambda *n: False)
    v, f = gripper.make(name)
    jv, jf = jgripper.make(name)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    gripper.save_obj(str(tmp_path / "t.obj"), v, f)
    jgripper.save_obj(str(tmp_path / "j.obj"), jv, jf)
    assert _bytes(tmp_path / "t.obj") == _bytes(tmp_path / "j.obj")
    with pytest.raises(ValueError, match="dropclip_tpu_torch"):
        gripper.make("nope")


def test_scene_grasps_filters_equal():
    g, j = _grasps(grasps, 1), _grasps(jgrasps, 1)
    for sel in (lambda x: x.filter_by_score(0.2),
                lambda x: x.filter_by_labels(2),
                lambda x: x.filter_by_labels([1, 3]),
                lambda x: x.select_topk(5),
                lambda x: x.sample(7, rng=np.random.default_rng(0))):
        a, b = sel(g), sel(j)
        for k in ("indices", "poses", "scores", "labels"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert repr(g) == repr(j) and len(g) == g.size == 20
    for (tv, tf), (jv, jf) in zip(g.to_meshes("marker"),
                                  j.to_meshes("marker")):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def test_scene_grasps_2d_rects_equal(monkeypatch):
    """``SceneGrasps2D.get_rects`` (cv2's ``boxPoints``, or the stand-in
    where cv2 is absent) equals the JAX package's."""
    use_cv2(monkeypatch)
    spec = [{"center": (20, 30), "angle": 0.3, "quality": 0.9, "width": 10}]
    np.testing.assert_array_equal(
        grasps.SceneGrasps2D(spec).get_rects()[0],
        jgrasps.SceneGrasps2D(spec).get_rects()[0])


def _rank_inputs(seed, n=400, g=48, c=16):
    rng = np.random.default_rng(seed)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    return dict(
        points=rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
        point_feats=rng.standard_normal((n, c)).astype(np.float32),
        point_mask=rng.random(n) > 0.1,
        grasp_positions=rng.uniform(-0.3, 0.3, (g, 3)).astype(np.float32),
        grasp_scores=rng.random(g).astype(np.float32),
        pos_emb=unit(rng.standard_normal(c)).astype(np.float32),
        neg_embs=unit(rng.standard_normal((4, c))).astype(np.float32))


def check_ranking(order, score, ref_order, ref_score):
    """Scores within SCORE_TOL of max|score|; the order equal wherever
    neighbouring reference scores are more than that apart (ties and
    near-ties may sort either way)."""
    order, score = np.asarray(order), np.asarray(score)
    ref_order, ref_score = np.asarray(ref_order), np.asarray(ref_score)
    tol = SCORE_TOL * max(np.abs(ref_score).max(), 1e-12)
    np.testing.assert_allclose(score, ref_score, rtol=0, atol=tol)
    ranked = ref_score[ref_order]
    clear = np.ones(len(ranked), bool)
    gaps = np.diff(ranked) < -tol
    clear[1:] &= gaps
    clear[:-1] &= gaps
    np.testing.assert_array_equal(order[clear], ref_order[clear])


@pytest.mark.parametrize("method", ["paired", "argmax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_grasps_by_query_matches_jax(method, seed):
    kw = _rank_inputs(seed)
    order, score = grasps.rank_grasps_by_query(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()},
        radius=0.1, method=method)
    assert order.device.type == "cpu" and score.dtype == torch.float32
    jorder, jscore = jgrasps.rank_grasps_by_query(
        **{k: jnp.asarray(v) for k, v in kw.items()}, radius=0.1,
        method=method)
    check_ranking(order, score, jorder, jscore)
    # numpy inputs and no negatives take the same route
    kw["neg_embs"] = None
    order, score = grasps.rank_grasps_by_query(**kw, radius=0.1)
    jorder, jscore = jgrasps.rank_grasps_by_query(
        **{k: (jnp.asarray(v) if v is not None else None)
           for k, v in kw.items()}, radius=0.1)
    check_ranking(order, score, jorder, jscore)


def test_rank_radius_fault_is_seen():
    """The limit sees a radius compared unsquared (chip_smoke.py's planted
    fault): radius 0.1 against 0.1 ** 0.5."""
    kw = _rank_inputs(2)
    _, score = grasps.rank_grasps_by_query(**kw, radius=0.1 ** 0.5)
    _, jscore = jgrasps.rank_grasps_by_query(
        **{k: jnp.asarray(v) for k, v in kw.items()}, radius=0.1)
    with pytest.raises(AssertionError):
        check_ranking(np.argsort(-score.numpy()), score, np.argsort(
            -np.asarray(jscore)), jscore)


@pytest.mark.parametrize("gripper_type", GRIPPERS)
def test_export_grasp_scene_byte_equal(gripper_type, tmp_path):
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((200, 3)).astype(np.float32)
    rgb = rng.random((200, 3)).astype(np.float32)
    g, j = _grasps(grasps, 5, n=12), _grasps(jgrasps, 5, n=12)
    order = rng.permutation(12)
    for kw in (dict(order=order, top_k=5), dict(top_k=20)):
        got = viz.export_grasp_scene(str(tmp_path / "t" / "s"), xyz, rgb, g,
                                     gripper_type=gripper_type, **kw)
        ref = jviz.export_grasp_scene(str(tmp_path / "j" / "s"), xyz, rgb,
                                      j, gripper_type=gripper_type, **kw)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in ref] == ["s_cloud.pcd",
                                                   "s_grasps.obj"]
        for a, b in zip(got, ref):
            assert _bytes(a) == _bytes(b), a


def _jax_query_steps(jdir, sid, xyz, rgb, labels, feats, pos, negs,
                     top=None):
    """The JAX tool's viz_query steps (tools/make_visualizations.py:
    113-165) on numpy features and embeddings: (pred, sims, cand, order,
    score), the heatmap written under ``jdir``. ``top``: the candidate
    points, where equal sims leave the JAX tool's top 32 to the sort
    (default: its own)."""
    pos, negs = jnp.asarray(pos), jnp.asarray(negs)
    pred, sims = jpredict(jnp.asarray(feats), pos, negs, method="paired",
                          threshold=0.6)
    s = np.asarray(sims, np.float32)
    top = np.argsort(-s)[:32] if top is None else top
    poses = np.tile(np.eye(4), (len(top), 1, 1))
    poses[:, :3, 3] = xyz[top] + np.array([0, 0, 0.08])
    cand = jgrasps.SceneGrasps(indices=top, poses=poses, scores=s[top],
                               labels=labels[top])
    order, score = jgrasps.rank_grasps_by_query(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.ones(len(xyz), bool),
        jnp.asarray(poses[:, :3, 3]), jnp.asarray(cand.scores), pos, negs)
    jviz.export_similarity_heatmap(os.path.join(jdir, f"{sid}_query_heatmap"
                                                ".pcd"), xyz, s,
                                   threshold=0.6)
    return pred, s, cand, order, score


def _same_dumps(tdir, jdir, sid, cand, order, rgb, xyz):
    """The grasp-scene files byte-equal given the port's order; the
    heatmaps' points equal and colours within one 8-bit step."""
    jviz.export_grasp_scene(os.path.join(jdir, f"{sid}_query"), xyz,
                            None if rgb is None else np.clip(rgb, 0, 1),
                            cand, order=np.asarray(order), top_k=10)
    for name in (f"{sid}_query_cloud.pcd", f"{sid}_query_grasps.obj"):
        assert _bytes(os.path.join(tdir, name)) == \
            _bytes(os.path.join(jdir, name)), name
    tx, tcol = viz.load_pcd(os.path.join(tdir, f"{sid}_query_heatmap.pcd"))
    jx, jcol = viz.load_pcd(os.path.join(jdir, f"{sid}_query_heatmap.pcd"))
    np.testing.assert_array_equal(tx, jx)
    assert np.abs(tcol - jcol).max() <= 1 / 255 + 1e-7
    assert os.path.exists(os.path.join(tdir, f"{sid}_query_pred.pcd"))


def test_query_dumps_match_the_jax_steps(tmp_path):
    """``make_visualizations.query_dumps`` on one scene's features against
    the JAX tool's viz_query steps on the same features and text
    embeddings: the same prediction, the ranking within SCORE_TOL, and
    the grasp-scene files byte-equal."""
    rng = np.random.default_rng(7)
    n, c = 300, 16
    xyz = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    rgb = rng.random((n, 3)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    feats = rng.standard_normal((n, c)).astype(np.float32)
    emb = rng.standard_normal((5, c)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    table = {("a mug",): emb[:1], ("object", "thing", "texture", "stuff"):
             emb[1:]}
    sim = SimpleNamespace(encode_text=lambda p: torch.from_numpy(
        table[tuple(p)]))
    cfg = SimpleNamespace(viz_query="a mug", sim_norm_thresh=0.6,
                          sim_method="paired")
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    order, score = make_visualizations.query_dumps(
        tdir, "s0", xyz, rgb, labels, torch.from_numpy(feats), sim, cfg)
    pred, _, cand, jorder, jscore = _jax_query_steps(
        jdir, "s0", xyz, rgb, labels, feats, emb[0], emb[1:])
    check_ranking(order, score, jorder, jscore)
    _same_dumps(tdir, jdir, "s0", cand, order, rgb, xyz)
    assert np.asarray(pred).any()


def test_viz_query_through_make_visualizations(tmp_path):
    """``make_visualizations.main`` with ``viz_query`` on a checkpoint of
    the port's trainer (tiny student, a fake .npz dataset, a synthesised
    tiny-test CLIP file): each scene's query dumps equal the JAX tool's
    steps on the same student features and text embeddings (sims within
    1e-5; a tiny student gives many equal sims, so the candidates are the
    port's top 32; ranking within SCORE_TOL, grasp-scene files
    byte-equal)."""
    from dropclip_tpu_torch.similarity import predict_from_embeddings
    from dropclip_tpu_torch.data.synthetic import write_fake_processed_dataset
    from dropclip_tpu_torch.teachers import convert
    from dropclip_tpu_torch.tools import train_distil

    yaml = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "DistilBlender.yaml")
    data = str(tmp_path / "data")
    write_fake_processed_dataset(data, n_scenes=2, n_objects=2, feat_dim=16,
                                 fmt="npz")
    clip = str(tmp_path / "clip.pt")
    torch.save(convert.synthetic_openai_state_dict("tiny-test", seed=6), clip)
    opts = ["root_dir", data, "arch_3d", "tiny", "feat_dim", "16",
            "voxel_capacity", "256", "voxel_size", "0.02", "use_full_pc",
            "True", "batch_size_val", "2", "workers_val", "1", "clip_model",
            "tiny-test", "clip_checkpoint", clip, "sim_norm_thresh", "0.6"]
    ckpt = train_distil.main(["--config", yaml, "--device", "cpu", "--opts",
                              *opts, "batch_size", "2", "workers", "1",
                              "epochs", "1", "save_path",
                              str(tmp_path / "exp")])
    seen = []
    inner = make_visualizations.query_dumps

    def record(out_dir, sid, xyz, rgb, labels, feats, clip_sim, cfg):
        out = inner(out_dir, sid, xyz, rgb, labels, feats, clip_sim, cfg)
        seen.append((sid, xyz, rgb, labels, feats.numpy(),
                     clip_sim.encode_text(["a mug"])[0].numpy(),
                     clip_sim.encode_text(["object", "thing", "texture",
                                           "stuff"]).numpy(), out))
        return out

    tdir, jdir = str(tmp_path / "tviz"), str(tmp_path / "jviz")
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(make_visualizations, "query_dumps", record)
        make_visualizations.main(["--config", yaml, "--device", "cpu",
                                  "--opts", *opts, "resume", ckpt,
                                  "viz_dir", tdir, "max_scenes", "2",
                                  "viz_query", "a mug"])
    assert [x[0] for x in seen] == ["test_0000", "test_0001"]
    for sid, xyz, rgb, labels, feats, pos, negs, (order, score) in seen:
        _, sims = predict_from_embeddings(
            torch.from_numpy(feats), torch.from_numpy(pos),
            torch.from_numpy(negs), threshold=0.6)
        sims = sims.numpy()
        _, jsims, cand, jorder, jscore = _jax_query_steps(
            jdir, sid, xyz, rgb, labels, feats, pos, negs,
            top=np.argsort(-sims)[:32])
        np.testing.assert_allclose(sims, jsims, rtol=0, atol=1e-5)
        check_ranking(order, score, jorder, jscore)
        _same_dumps(tdir, jdir, sid, cand, order, rgb, xyz)
