"""The ViT-H/14 ingest cell (``mvtod_h14.ingest``): on the CPU at a tiny
size (the ``tiny-test-h14`` CLIP: four heads of 80, exact GELU; 4 views
at 48x64, 3 objects) the counting of the cell's work against its shapes,
and the whole run (the harness's look for a card skipped), sound and
with a stand-in in the program's place; on the card at the cell's size,
the fp8 control and both planted faults fail ``crop_feat_gap`` and the
sound run passes it."""

import pytest
import torch

from benchmark import counting_vit, harness
from benchmark.drivers import ingest_openclip as driver
from benchmark.reference import openclip

SEED = 2 ** 40 + 11
CELL = "mvtod_h14.ingest"


def files():
    spec = harness.spec_of()
    cell = harness.cell_of(spec, CELL)
    config = harness.load_json(f"{harness.HERE}/configs/"
                               f"{cell['config']}.json")
    traffic = harness.load_json(f"{harness.HERE}/traffic/"
                                f"{cell['traffic']}.json")
    return cell, config, traffic


def tiny():
    cell, config, traffic = files()
    config.update(clip_model="tiny-test-h14", text_width=32, text_layers=2,
                  text_heads=4, embed_dim=16)
    traffic.update(views=4, hw=[48, 64], reference_batch=8,
                   intrinsics=dict(fx=44.444, fy=44.444, cx=31.5, cy=23.5))
    traffic["cameras"].update(elevations_deg=[40.0], per_ring=3)
    traffic["table"].update(top_z_m=0.01)
    traffic["objects"].update(n=3)
    traffic["teacher"].update(image_resolution=28, vision_width=320,
                              vision_layers=2, vision_heads=4,
                              img_resize=[28, 42])
    traffic["ingest"].update(voxel_size=0.02, cloud_capacity=4096, chunk=8)
    return cell, config, traffic


def run_tiny(stand_in=None):
    cell, config, traffic = tiny()
    return harness.run_cell(cell, SEED, 0.5, False, 0.0, device="cpu",
                            config=config, traffic=traffic,
                            stand_in=stand_in)


def test_cell_files_state_vit_h14():
    """The configuration and the traffic hold ViT-H/14's published sizes,
    and the program's configuration of the name agrees with them."""
    from dropclip_tpu_torch.teachers.clip import CLIP_CONFIGS

    _, config, traffic = files()
    t, c = traffic["teacher"], CLIP_CONFIGS[config["clip_model"]]
    assert (t["vision_width"], t["vision_layers"], t["vision_heads"],
            t["patch_size"], t["image_resolution"]) == (
        c["vision_width"], c["vision_layers"], c["vision_heads"],
        c["vision_patch_size"], c["image_resolution"]) == (
        1280, 32, 16, 14, 224)
    assert t["vision_width"] // t["vision_heads"] == 80
    assert t["activation"] == c["activation"] == "gelu"
    assert tuple(t["img_resize"]) == c["img_resize"] == (224, 294)
    assert (config["text_width"], config["text_layers"],
            config["text_heads"], config["embed_dim"]) == (
        c["transformer_width"], c["transformer_layers"],
        c["transformer_heads"], c["embed_dim"]) == (1024, 24, 16, 1024)
    assert config["reduced"] == [] and config["feat_dim"] == 1024


def test_counting_matches_the_shapes():
    """The driver's counting of one crop and one attention launch at the
    cell's sizes, against the products of the tower's shapes written
    out: 337 tokens (16 x 21 patches and the class token), 32 blocks of
    the four 1280 x 1280 projections and the 1280 x 5120 MLP, the two
    attention products of 16 heads of 80, the 588 -> 1280 patch
    embedding and the 1280 -> 1024 projection."""
    _, config, traffic = files()
    t = traffic["teacher"]
    assert counting_vit.vit_tokens(t) == 337
    flops = counting_vit.vit_flops(t, config["embed_dim"])
    tok, w, layers = 337, 1280, 32
    block = 2 * tok * (4 * w * w + 2 * w * 4 * w)
    assert flops["linear"] == 2 * 336 * 588 * w + layers * block \
        + 2 * w * 1024
    assert flops["attention"] == layers * 16 * 2 * (2 * tok * tok * 80)
    one = counting_vit.attention_launch(t, 96)
    assert one["flops"] == 96 * 16 * 2 * (2 * tok * tok * 80)
    assert one["bytes"] == 4 * 96 * tok * 16 * 80 * 2
    # 730 crops a scene through the tower: about 310 TFLOP of linears
    assert 300e12 < 730 * flops["linear"] < 320e12


def test_reference_towers_match_the_program():
    """The program's tiny ViT-H-shaped CLIP (bf16) against the reference
    in bf16: within 2% of each row; quick-GELU and heads of 64 in the
    reference move it further."""
    from benchmark.drivers import ingest as base
    from dropclip_tpu_torch.teachers.clip import build_clip

    _, config, traffic = tiny()
    t = traffic["teacher"]
    w = base.draw_teacher(config, t, 3, "cpu")
    model = build_clip("tiny-test-h14", dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(w)
    pixels = torch.randn(3, 28, 42, 3, generator=torch.Generator()
                         .manual_seed(0))
    with torch.no_grad():
        got = model.encode_image(pixels).float()
        want = openclip.encode_image(w, pixels, 4, 14)
        quick = openclip.encode_image(w, pixels, 4, 14, act="quick_gelu")
    gap = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max()
    assert gap < 0.02
    assert ((quick - want).norm(dim=-1) / want.norm(dim=-1)).max() > gap


def test_sound_run_is_correct():
    run = run_tiny()
    assert run.correct(), run.checks
    assert run.attempted > 0 and run.failed == 0


def test_traced_run_keeps_the_phase_times(monkeypatch):
    """A traced run keeps one scene's phase times after its traced scenes,
    as ``drivers/ingest.py`` does, so that ``ingest.teacher_ms``,
    ``ingest.aggregate_ms`` and ``ingest.fuse_ms`` have something to read
    in this cell too. The profiler is the card's, so the tiny CPU run
    takes a stand-in that runs the traced scenes unprofiled."""
    from types import SimpleNamespace

    def counted_profile(unit, n, launches, match):
        return SimpleNamespace(units=[unit() for _ in range(n)])

    monkeypatch.setattr(driver.trace, "counted_profile", counted_profile)
    cell, config, traffic = tiny()
    run = harness.run_cell(cell, SEED, 0.5, True, 0.0, device="cpu",
                           config=config, traffic=traffic)
    assert run.correct(), run.checks
    for name in ("teacher", "aggregate", "fuse"):
        ms = harness.reader(f"ingest.{name}_ms").read(run)
        assert ms is not None and ms > 0, name


@pytest.mark.parametrize("stand_in", sorted(driver.STAND_INS))
def test_stand_in_moves_the_comparison(stand_in):
    """Each stand-in in the program's place moves a compared number to
    more than 1.4 times the sound run's (and above 1e-3): at two blocks of
    width 320 quick-GELU moves the features less than the cell's limits,
    which the card's test at the cell's size holds them to."""
    sound = {n: v for n, v, _ in run_tiny().checks}
    moved = {n: v for n, v, _ in run_tiny(stand_in).checks}
    assert any(v > max(1.4 * sound[n], 1e-3) for n, v in moved.items()), \
        (sound, moved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs ViT-H/14 at its "
                    "published widths")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("stand_in", [None] + sorted(driver.STAND_INS))
def test_crop_features_at_the_cells_size(card, stand_in):
    """The cell on the card with a 2 s window: the sound run is correct,
    and the fp8 control, quick-GELU in GELU's place and heads of 64 each
    fail ``crop_feat_gap``."""
    cell, _, _ = files()
    run = harness.run_cell(cell, SEED, 2.0, False, 0.0, stand_in=stand_in)
    checks = {n: (v, lim) for n, v, lim in run.checks}
    value, limit = checks["crop_feat_gap"]
    if stand_in is None:
        assert run.correct(), run.checks
    else:
        assert value > limit, (stand_in, value, limit)
