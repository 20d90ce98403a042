"""Grounding and segmentation eval: dropclip_tpu_torch.distill.evaluate
against dropclip_tpu.distill.evaluate on one loader of a fake processed
dataset, the tiny student's weights carried across by
``convert.student_state_dict`` and the text towers read from one
synthesised CLIP checkpoint file by both packages' ``load_params``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill import evaluate as jev
from dropclip_tpu.distill.engine import build_student_for as jstudent
from dropclip_tpu.distill.engine import build_topology as jtopology
from dropclip_tpu.distill.loss import cosine_distil_loss as jcosine
from dropclip_tpu.similarity import ClipSimilarity as JSim
from dropclip_tpu.teachers import convert as jconvert
from dropclip_tpu.teachers.clip import build_clip as jbuild_clip
from dropclip_tpu_torch.convert import student_state_dict
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data.dataset_blender import MVTODDataset
from dropclip_tpu_torch.data.synthetic import write_fake_processed_dataset
from dropclip_tpu_torch.distill import evaluate as ev
from dropclip_tpu_torch.distill.engine import build_student_for, \
    make_eval_step
from dropclip_tpu_torch.distill.train_state import DistilTrainState
from dropclip_tpu_torch.similarity import ClipSimilarity, predict_queries
from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities
from dropclip_tpu_torch.teachers import convert

CFG = dict(arch_3d="tiny", feat_dim=16, voxel_capacity=256, voxel_size=0.02,
           use_color=True, sparse_backend="bricks", brick_shape=[4, 4, 2],
           use_full_pc=True, eval_scenario="cls", sim_method="paired",
           sim_norm_thresh=0.75, sim_negatives="generic", n_classes=5,
           ignore_label=255)
NEAR = 1e-4  # normalized sims this close to the threshold may flip
CLASSES = ["can", "spoon", "fork", "mug", "bowl"]


def _split(batch, s):
    """Scene ``s`` of a collated batch as a batch of one."""
    return {k: (v[s:s + 1] if isinstance(v, (np.ndarray, list)) else v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    write_fake_processed_dataset(str(tmp / "data"), n_scenes=4,
                                 splits=("test",), n_objects=3, feat_dim=16)
    ckpt = str(tmp / "clip.pt")
    torch.save(convert.synthetic_openai_state_dict("tiny-test", seed=1), ckpt)
    ds = MVTODDataset(CfgNode(dict(CFG, root_dir=str(tmp / "data"))), "test")
    batches = [MVTODDataset.collate([ds[2 * i], ds[2 * i + 1]])
               for i in range(2)]
    rng = np.random.default_rng(0)
    for b in batches:  # class ids for the segmentation eval
        b["labels_cls"] = rng.integers(0, 5, b["labels"].shape)
        b["labels_cls"][:, :20] = 255
    caps = list(autotune_brick_capacities(
        np.concatenate([b["coords"] for b in batches]),
        np.concatenate([b["mask"] for b in batches]),
        brick_shape=(4, 4, 2), slack=1.5))
    cfg = dict(CFG, brick_capacities=caps)

    jcfg = JCfg(dict(cfg))
    jmodel = jstudent(jcfg)
    coords = jnp.zeros((1, 256, 3), jnp.int32)
    mask = jnp.zeros((1, 256), bool).at[:, :16].set(True)
    jvars = jax.jit(lambda t, f: jmodel.init(
        jax.random.PRNGKey(0), t, f, train=False))(
        jtopology(jcfg, coords, mask), jnp.zeros((1, 256, 6), jnp.float32))

    @jax.jit
    def japply(variables, coords, mask, feats, targets):
        out = jmodel.apply(variables, jtopology(jcfg, coords, mask), feats,
                           train=False)
        return out, jcosine(out, targets, mask)

    def jforward(b):
        return japply(jvars, *(jnp.asarray(b[k]) for k in (
            "coords", "mask", "in_feats", "targets")))

    tcfg = CfgNode(dict(cfg))
    model = build_student_for(tcfg)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    model.load_state_dict(student_state_dict(
        np_tree(jvars["params"]), np_tree(jvars.get("batch_stats", {}))))
    state = DistilTrainState(step=0, model=model, tx=None, opt_state=None)
    step = make_eval_step(tcfg)

    def tforward(b):
        from dropclip_tpu_torch.tools.train_distil import to_batch

        out, m = step(state, to_batch(b, "cpu"))
        return out, m["distil_loss"]

    def memo(forward):
        """The forward of each distinct batch (keyed by its scenes) runs
        once."""
        seen = {}

        def run(b):
            key = tuple(b["scene_id"])
            if key not in seen:
                seen[key] = forward(b)
            return seen[key]
        return run

    jsim = JSim(jbuild_clip("tiny-test", use_flash=False),
                {"params": jconvert.load_params(ckpt)})
    tsim = ClipSimilarity(convert.build_clip_text_from(
        "tiny-test", ckpt, dtype=torch.float32), "cpu")
    return dict(batches=batches, jforward=memo(jforward),
                tforward=memo(tforward), jsim=jsim, tsim=tsim, cfg=cfg)


def near_threshold(setup, batch, cfg, cls_list):
    """Valid points whose normalized sim (the one the scorer thresholds)
    lies within NEAR of the threshold, over the scenes of ``batch``."""
    out, _ = setup["tforward"](batch)
    thr, n = float(cfg["sim_norm_thresh"]), 0
    for s in range(out.shape[0]):
        plan = ev.scene_query_plan(batch["queries"][s],
                                   cfg["sim_negatives"], cls_list)
        pos, negs, nmask, use_negs, _, qmask, _ = ev._pad_queries(
            setup["tsim"], plan, np.asarray(batch["labels"][s]), 32, 64,
            out.shape[-1], "cpu")
        mask = torch.as_tensor(batch["mask"][s])
        _, s_n = predict_queries(out[s], pos, negs, mask, cfg["sim_method"],
                                 thr, neg_mask=nmask)
        _, s_0 = predict_queries(out[s], pos, None, mask, cfg["sim_method"],
                                 thr)
        sims = torch.where(use_negs[:, None], s_n, s_0)
        n += int(((sims - thr).abs() < NEAR)[qmask][:, mask].sum())
    return n


@pytest.mark.parametrize("method,negatives", [
    ("paired", "generic"), ("paired", "scene"), ("paired", "no"),
    ("argmax", "all"), ("argmax", "scene")])
def test_validate_grounding_matches_jax(setup, method, negatives):
    """The two scenes of the first batch one by one, and the whole loader
    with and without compat_last_scene_only: every metric within 1e-6 of
    the JAX function's where no point's normalized sim lies within 1e-4
    of the threshold (such points are reported, not held); DistilLoss
    within 1e-5 always."""
    cfg = dict(setup["cfg"], sim_method=method, sim_negatives=negatives)
    cls_list = CLASSES if negatives == "all" else None
    first = setup["batches"][0]
    runs = [([_split(first, s)], False) for s in range(2)] + \
        [(setup["batches"], False), (setup["batches"], True)]
    held = 0
    for loader, compat in runs:
        ref = jev.validate_grounding(loader, setup["jforward"], setup["jsim"],
                                     JCfg(dict(cfg)), cls_list=cls_list,
                                     compat_last_scene_only=compat)
        got = ev.validate_grounding(loader, setup["tforward"], setup["tsim"],
                                    CfgNode(dict(cfg)), cls_list=cls_list,
                                    compat_last_scene_only=compat)
        assert set(got) == set(ref)
        assert got["DistilLoss"] == pytest.approx(ref["DistilLoss"],
                                                  abs=1e-5)
        near = sum(near_threshold(setup, b, cfg, cls_list) for b in loader)
        if near:
            print(f"{method}/{negatives} compat={compat}: {near} points "
                  f"within {NEAR} of the threshold; metrics {got} vs {ref}")
            continue
        held += 1
        for k in ("mIoU", "Pr@25", "Pr@50", "Pr@75"):
            assert got[k] == pytest.approx(ref[k], abs=1e-6), (k, got, ref)
    assert held >= 2  # most runs are held, not reported


def test_validate_segmentation_matches_jax(setup):
    cfg = setup["cfg"]
    ref = jev.validate_segmentation(
        setup["batches"], setup["jforward"],
        setup["jsim"].encode_text(CLASSES), JCfg(dict(cfg)))
    got = ev.validate_segmentation(
        setup["batches"], setup["tforward"],
        setup["tsim"].encode_text(CLASSES), CfgNode(dict(cfg)))
    assert set(got) == set(ref)
    for k in ("mIoU", "mAcc", "allAcc"):
        assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    assert got["SimLoss"] == pytest.approx(ref["SimLoss"], abs=1e-5)
    with pytest.raises(KeyError, match="labels_cls"):
        ev.validate_segmentation(
            [{k: v for k, v in setup["batches"][0].items()
              if k != "labels_cls"}], setup["tforward"],
            setup["tsim"].encode_text(CLASSES), CfgNode(dict(cfg)))


@pytest.mark.parametrize("negatives", ["generic", "scene", "no", "all"])
def test_scene_query_plan_matches_jax(negatives):
    """Blender ({id: [texts]}) and REGRAD ({name: [ids]}) formats."""
    scenes = [{0: ["table"], 1: ["mug", "red mug"], 2: ["bowl"],
               3: ["can"]},
              {"mug": [1, 3], "bowl": [2], "spoon": [4, 5]}]
    for q in scenes:
        got = ev.scene_query_plan(q, negatives, CLASSES)
        assert got == jev.scene_query_plan(q, negatives, CLASSES)
        assert got
    with pytest.raises(ValueError):
        ev.scene_query_plan(scenes[0], "all")


@pytest.mark.parametrize("method", ["paired", "argmax"])
def test_batched_scorer_equals_per_query_loop(setup, method):
    """One batched scorer call equals predict_from_embeddings query by
    query; ground truths shifted by one query read different metrics."""
    from dropclip_tpu_torch.core.metrics import grounding_metrics
    from dropclip_tpu_torch.similarity import predict_from_embeddings

    b = setup["batches"][0]
    out, _ = setup["tforward"](b)
    plan = ev.scene_query_plan(b["queries"][0], "scene")
    pos, negs, nmask, use_negs, gts, qmask, _ = ev._pad_queries(
        setup["tsim"], plan, np.asarray(b["labels"][0]), 8, 8,
        out.shape[-1], "cpu")
    mask = torch.as_tensor(b["mask"][0])
    miou, pr = ev.make_grounding_scorer(method, 0.75)(
        out[0], mask, pos, negs, nmask, use_negs, gts, qmask)
    preds = []
    for i in range(len(plan)):
        k = int(nmask[i].sum())
        preds.append(predict_from_embeddings(
            out[0], pos[i], negs[i, :k], mask=mask, method=method,
            threshold=0.75)[0])
    ref_miou, ref_pr = grounding_metrics(
        torch.stack(preds).float(), gts[:len(plan)] & mask, point_mask=mask)
    assert float(miou) == pytest.approx(float(ref_miou), abs=1e-6)
    np.testing.assert_allclose(pr.numpy(), ref_pr.numpy(), atol=1e-6)
    shifted = torch.roll(gts[:len(plan)], 1, dims=0)
    bad, _ = ev.make_grounding_scorer(method, 0.75)(
        out[0], mask, pos[:len(plan)], negs[:len(plan)],
        nmask[:len(plan)], use_negs[:len(plan)], shifted, qmask[:len(plan)])
    assert float(bad) != pytest.approx(float(miou), abs=1e-3)
