"""The whole run on the CPU at a tiny size (the harness's look for a card
skipped), with the timed path broken underneath: ``correct`` must come
out false for every fault a cell can have, and true without one."""

import pytest
import torch

from benchmark import harness

SEED = 2 ** 40 + 3


def tiny(cell_name):
    spec = harness.spec_of()
    cell = harness.cell_of(spec, cell_name)
    config = harness.load_json(f"{harness.HERE}/configs/"
                               f"{cell['config']}.json")
    traffic = harness.load_json(f"{harness.HERE}/traffic/"
                                f"{cell['traffic']}.json")
    config.update(planes=[4, 4, 8, 8, 8, 8, 4, 4], arch_3d="tiny",
                  feat_dim=16, voxel_capacity=512)
    if traffic["driver"] == "train":
        config.update(batch_size=2)
        traffic.update(ring=3)
        if traffic["scenes"]["shape"] == "tabletop":
            traffic["scenes"] = dict(shape="tabletop", voxels=[150, 250],
                                     ext=10)
        else:
            traffic["scenes"] = dict(shape="surfaces", voxels=[150, 250],
                                     n_objects=3, radius_mm=[4.0, 8.0],
                                     spread_mm=10.0)
    else:
        config.update(clip_model="tiny-test", text_width=32, text_layers=2,
                      text_heads=4, embed_dim=16)
        traffic.update(ring=6, scenes_per_call=2, checked_calls=3,
                       warm_calls=1,
                       scenes=dict(shape="tabletop", voxels=[200, 300],
                                   ext=12))
    return cell, config, traffic


def run_tiny(cell_name):
    cell, config, traffic = tiny(cell_name)
    return harness.run_cell(cell, SEED, 0.5, False, 0.0, device="cpu",
                            config=config, traffic=traffic)


TRAIN = [c["name"] for c in harness.spec_of()["workloads"]
         if harness.load_json(f"{harness.HERE}/traffic/{c['traffic']}.json")
         ["driver"] == "train"]
SERVE = [c["name"] for c in harness.spec_of()["workloads"]
         if harness.load_json(f"{harness.HERE}/traffic/{c['traffic']}.json")
         ["driver"] == "serve"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    run = run_tiny(cell)
    assert run.correct(), run.checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("cell", TRAIN)
def test_train_state_left_unchanged(cell, monkeypatch):
    from dropclip_tpu_torch.distill import train_state

    def update(self, model, opt_state, count=None):
        opt_state["count"] += 1
        return torch.zeros(())

    monkeypatch.setattr(train_state.AmsgradChain, "update", update)
    assert not run_tiny(cell).correct()


@pytest.mark.parametrize("cell", TRAIN)
def test_train_half_batch_left_out(cell, monkeypatch):
    from dropclip_tpu_torch.distill import engine

    real = engine._compute_losses

    def half(model_out, batch, cfg):
        mask = batch.mask.clone()
        mask[mask.shape[0] // 2:] = False
        return real(model_out, batch._replace(mask=mask), cfg)

    monkeypatch.setattr(engine, "_compute_losses", half)
    assert not run_tiny(cell).correct()


@pytest.mark.parametrize("cell", SERVE)
def test_serve_answer_altered(cell, monkeypatch):
    from dropclip_tpu_torch import pipeline

    real = pipeline.GroundingPipeline.ground_batch

    def altered(self, *a, **kw):
        masks, sims = real(self, *a, **kw)
        sims = sims.copy()
        sims[0, 0, 0] = 1.0 - sims[0, 0, 0]
        masks[0] = ~masks[0]
        return masks, sims

    monkeypatch.setattr(pipeline.GroundingPipeline, "ground_batch", altered)
    assert not run_tiny(cell).correct()


@pytest.mark.parametrize("cell", SERVE)
def test_serve_half_batch_left_out(cell, monkeypatch):
    from dropclip_tpu_torch import pipeline

    real = pipeline.GroundingPipeline._forward

    def half(self, coords, mask, in_feats):
        out = real(self, coords, mask, in_feats)
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(pipeline.GroundingPipeline, "_forward", half)
    assert not run_tiny(cell).correct()


@pytest.mark.parametrize("cell", SERVE)
def test_serve_student_below_its_precision(cell, monkeypatch):
    from dropclip_tpu_torch import pipeline

    real = pipeline.GroundingPipeline._forward

    def rounded(self, coords, mask, in_feats):
        return real(self, coords, mask, in_feats).bfloat16().float()

    monkeypatch.setattr(pipeline.GroundingPipeline, "_forward", rounded)
    run = run_tiny(cell)
    assert dict((n, v > lim) for n, v, lim in run.checks)[
        "student_score_gap"]
