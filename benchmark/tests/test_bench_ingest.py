"""The ingest cell on the CPU at a tiny size (the ``tiny-test`` CLIP, 4
views at 48x64, 3 objects): the dense renderer against a brute-force
ray march, the plain reference against the program, and the whole run
(the harness's look for a card skipped) with the timed path broken
underneath or a stand-in in its place: ``correct`` must come out false
for each, and true without one."""

import numpy as np
import pytest
import torch

from benchmark import gen, harness, render
from benchmark.drivers import ingest as driver
from benchmark.reference import clip_text, clip_vision
from benchmark.reference import ingest as ref

SEED = 2 ** 40 + 7
CELL = "mvtod.ingest"


def tiny():
    spec = harness.spec_of()
    cell = harness.cell_of(spec, CELL)
    config = harness.load_json(f"{harness.HERE}/configs/"
                               f"{cell['config']}.json")
    traffic = harness.load_json(f"{harness.HERE}/traffic/"
                                f"{cell['traffic']}.json")
    config.update(clip_model="tiny-test", text_width=32, text_layers=2,
                  text_heads=4, embed_dim=16)
    traffic.update(views=4, hw=[48, 64], reference_batch=8,
                   intrinsics=dict(fx=44.444, fy=44.444, cx=31.5, cy=23.5))
    traffic["cameras"].update(elevations_deg=[40.0], per_ring=3)
    traffic["table"].update(top_z_m=0.01)
    traffic["objects"].update(n=3)
    traffic["teacher"].update(image_resolution=32, vision_width=64,
                              vision_layers=2, vision_heads=1,
                              patch_size=16)
    traffic["ingest"].update(voxel_size=0.02, cloud_capacity=4096, chunk=8)
    return cell, config, traffic


def run_tiny(stand_in=None):
    cell, config, traffic = tiny()
    return harness.run_cell(cell, SEED, 0.5, False, 0.0, device="cpu",
                            config=config, traffic=traffic,
                            stand_in=stand_in)


def solids(p, lay, table):
    """(..., S) bool: ``p`` inside the table (a 2 cm slab under its top)
    or inside each object."""
    hx, hy = table["half_extent_m"]
    z = lay["table_z"]
    ids = [(np.abs(p[..., 0]) <= hx) & (np.abs(p[..., 1]) <= hy)
           & (p[..., 2] <= z) & (p[..., 2] >= z - 0.02)]
    for obj in lay["objects"]:
        q = p - obj["centre"]
        if obj["kind"] == "sphere":
            ids.append((q ** 2).sum(-1) <= obj["half"][0] ** 2)
        else:
            c, s = np.cos(obj["yaw"]), np.sin(obj["yaw"])
            lx = c * q[..., 0] + s * q[..., 1]
            ly = -s * q[..., 0] + c * q[..., 1]
            ids.append((np.abs(lx) <= obj["half"][0])
                       & (np.abs(ly) <= obj["half"][1])
                       & (np.abs(q[..., 2]) <= obj["half"][2]))
    return np.stack(ids, -1)


def march(o, d, lay, table, t_hi=3.0, step=5e-4, block=256):
    """Depth and segment of each ray by marching it in small steps until
    it enters a solid, then bisecting the step: independent of the
    renderer's intersections."""
    ts = np.arange(0.05, t_hi, step)
    depth = np.full(len(d), np.inf)
    seg = np.zeros(len(d), np.int64)
    for b in range(0, len(d), block):
        db = d[b:b + block]
        hit = solids(o + ts[None, :, None] * db[:, None, :], lay,
                     table).any(-1)
        ok = hit.any(1)
        k = np.argmax(hit, 1)
        lo, hi = ts[np.maximum(k - 1, 0)], ts[k]
        for _ in range(30):
            mid = (lo + hi) / 2
            inn = solids(o + mid[:, None] * db, lay, table).any(-1)
            hi, lo = np.where(inn, mid, hi), np.where(inn, lo, mid)
        depth[b:b + block] = np.where(ok, hi, np.inf)
        seg[b:b + block] = np.where(ok, np.argmax(solids(
            o + hi[:, None] * db, lay, table), -1), 0)
    return depth, seg


def test_dense_render_matches_a_ray_march():
    _, _, traffic = tiny()
    lay = render.layout(traffic, gen.rng_for(SEED, 4))
    scene = render.render(lay, traffic, "cpu")
    v = 1
    o, d = render.rays(torch.as_tensor(lay["poses"][v:v + 1]),
                       torch.as_tensor(lay["K"]), traffic["hw"])
    depth, seg = march(o[0].double().numpy(), d[0].double().numpy(), lay,
                       traffic["table"])
    got_d = scene["depths"][v].reshape(-1).astype(np.float64)
    got_s = scene["segs"][v].reshape(-1).astype(np.int64)
    hit = np.isfinite(depth)
    assert ((got_d < 25) == hit).mean() > 0.99
    both = hit & (got_d < 25) & (got_s == seg)
    assert (got_s[hit] == seg[hit]).mean() > 0.98
    assert np.abs(got_d[both] - depth[both]).max() < 2e-3
    assert scene["images"].dtype == np.uint8 and scene["segs"].max() == 3


def test_vision_tower_matches_the_program():
    from dropclip_tpu_torch.teachers.clip import build_clip

    _, config, traffic = tiny()
    t = traffic["teacher"]
    w = driver.draw_teacher(config, t, 3, "cpu")
    model = build_clip("tiny-test", dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(w)
    pixels = torch.randn(3, 336, 448, 3, generator=torch.Generator()
                         .manual_seed(0))
    with torch.no_grad():
        got = model.encode_image(pixels).float()
        want = clip_vision.encode(w, pixels, t["vision_heads"],
                                  t["patch_size"])
        fp8 = clip_vision.encode(w, pixels, t["vision_heads"],
                                 t["patch_size"], "fp8")
    gap = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max()
    assert gap < 0.02
    assert ((fp8 - want).norm(dim=-1) / want.norm(dim=-1)).max() > 3 * gap


def test_reference_ingest_matches_process_scene():
    """The program's ``process_scene`` on one tiny scene against the
    reference, through the driver's own comparison."""
    cell, config, traffic = tiny()
    limits = harness.load_json(f"{harness.HERE}/limits/{CELL}.json")
    run = harness.Run(cell, config, traffic, limits, SEED, 1.0, False, 0.0,
                      "cpu")
    ring = render.make_ring(dict(traffic, ring=1), SEED, "cpu")
    w = driver.draw_teacher(config, traffic["teacher"], 5, "cpu")
    job = driver.Ingest(driver.build_extractor(run, w), ring,
                        traffic["ingest"])
    job.scenes(0, lambda m: m < 1)
    got = dict(scene=job.out[0], fusion={
        k: v.float() if v.is_floating_point() else v
        for k, v in job.fusion[0].items()})
    tok = clip_text.Tokenizer(f"{harness.ROOT}/{driver.VOCAB}")
    r = driver.reference_scene(run, w, ring[0], tok)
    nums = driver.compare(run, got, r, ring[0])
    assert set(nums) == set(run.limits) | set(run.not_compared)
    for name, limit in run.limits.items():
        assert nums[name] <= limit, (name, nums[name])
    assert len(r["key"]) > 100 and r["present"].sum() > 6


def test_sound_run_is_correct():
    run = run_tiny()
    assert run.correct(), run.checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("stand_in", sorted(driver.STAND_INS))
def test_stand_in_is_not_correct(stand_in):
    assert not run_tiny(stand_in).correct()


def test_half_the_chunk_left_out(monkeypatch):
    from dropclip_tpu_torch.teachers.extractor import ClipExtractor

    real = ClipExtractor._obj_prior_packed

    def half(self, images, seg, vidx, oids):
        emb = real(self, images, seg, vidx, oids)
        emb[emb.shape[0] // 2:] = 0
        return emb

    monkeypatch.setattr(ClipExtractor, "_obj_prior_packed", half)
    assert not run_tiny().correct()


def test_answer_altered(monkeypatch):
    from dropclip_tpu_torch.tools import preprocess_data

    real = preprocess_data.finalize_scene

    def altered(*a, **kw):
        scene, stats = real(*a, **kw)
        scene["obj_feats"][1] = -scene["obj_feats"][1]
        return scene, stats

    monkeypatch.setattr(preprocess_data, "finalize_scene", altered)
    assert not run_tiny().correct()


def test_present_pairs_and_queries_by_hand():
    segs = np.zeros((2, 4, 4), np.uint8)
    segs[0, 0, 0], segs[1, 1, 1], segs[1, 2, 2] = 3, 1, 3
    assert ref.present_pairs(segs, 5).tolist() == [
        [False, False, False, True, False], [False, True, False, True,
                                             False]]
    info = {0: {"cls_name": "table", "concepts": None},
            1: {"cls_name": "mug", "concepts": {"More descriptions":
                                                ["a red mug"]}},
            2: {"cls_name": "box", "concepts": None}}
    assert ref.query_texts(info) == {0: ["table"], 1: ["a red mug", "mug"],
                                     2: ["box"]}
