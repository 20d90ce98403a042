"""dropclip_tpu_torch imports with none of jax, flax, the JAX package,
regex, yaml, h5py, triton, matplotlib, PIL or cv2 available (the card's
machine has only torch, triton, numpy, scipy, einops, pytest and
hypothesis; matplotlib and PIL are imported only inside the viz functions
that draw, cv2 only inside the image readers), and its entry points (serve pipeline on either engine and
from a checkpoint, pillar topology, text encoder, CLIP, ingest staging,
the trainer, the eval and viz CLIs, the DINO teachers and the extraction
CLIs, the raw-data ingest and the cleanup filters) refuse to run without a
card unless asked for the CPU; the trainer's data paths (MV-TOD and
REGRAD) read .npz scenes with no h5py, and the RLE codec runs without
cv2."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "dropclip_tpu",
             "regex", "yaml", "h5py", "triton", "matplotlib", "PIL", "cv2"):
    sys.modules[name] = None  # any import of these raises ImportError
import importlib, pkgutil
import dropclip_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(n for n in ("jax", "flax", "dropclip_tpu", "regex", "yaml",
                            "h5py", "triton", "matplotlib", "PIL", "cv2")
                if sys.modules.get(n) is not None)
assert not leaked, leaked
for m in ("teachers.convert", "distill.evaluate", "viz",
          "tools.validate_blender", "tools.validate_upper_bound",
          "tools.run_eval", "tools.make_visualizations", "teachers.dinov2",
          "teachers.dino_v1", "tools.dino_extract", "tools.clip_extract",
          "native", "data.rle", "data.blender", "data.regrad",
          "data.dataset_regrad", "geom.cleanup", "geom.knn", "grasp",
          "grasp.grasps", "grasp.gripper"):
    assert "dropclip_tpu_torch." + m in mods, m
import torch
torch.cuda.is_available = lambda: False
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.pipeline import GroundingPipeline, make_clip_sim
cfg = CfgNode(dict(arch_3d="tiny", feat_dim=8, voxel_capacity=64,
                   sparse_backend="bricks", clip_checkpoint="random",
                   clip_model="tiny-test"))
pcfg = CfgNode(dict(cfg, sparse_backend="pillars"))
from dropclip_tpu_torch.sparse.pillar_topology import build_pillar_topology
from dropclip_tpu_torch.teachers.clip import build_clip
from dropclip_tpu_torch.tools.preprocess_data import stage_scene
from dropclip_tpu_torch.tools.train_distil import main as train_main
from dropclip_tpu_torch.tools import (make_visualizations, run_eval,
                                      validate_blender, validate_upper_bound)
from dropclip_tpu_torch.teachers.convert import build_clip_from
from dropclip_tpu_torch.teachers.dinov2 import build_dinov2
from dropclip_tpu_torch.teachers.dino_v1 import ViTExtractor, build_dino_v1
from dropclip_tpu_torch.tools import clip_extract, dino_extract
from dropclip_tpu_torch.tools import preprocess_data
from dropclip_tpu_torch.geom import cleanup
import numpy as np
import tempfile
z = np.zeros((1, 4, 4), np.float32)
y = "configs/DistilBlender.yaml"
empty_raw = tempfile.mkdtemp()
import os
os.makedirs(os.path.join(empty_raw, "train"))
for make in (lambda: GroundingPipeline(cfg), lambda: GroundingPipeline(pcfg),
             lambda: GroundingPipeline.from_checkpoint(y, "nowhere"),
             lambda: validate_blender.main(["--config", y]),
             lambda: validate_upper_bound.main(["--config", y]),
             lambda: run_eval.main(["--clip-model", "tiny-test"]),
             lambda: make_visualizations.main(["--config", y]),
             lambda: build_clip_from("tiny-test", "random"),
             lambda: build_pillar_topology(np.zeros((4, 3)), np.ones(4)),
             lambda: make_clip_sim(cfg),
             lambda: build_clip("tiny-test"),
             lambda: build_clip("tiny-test-rn"),
             lambda: build_dinov2("tiny-test"),
             lambda: build_dino_v1("tiny-test", 4),
             lambda: ViTExtractor("tiny-test"),
             lambda: dino_extract.main(["--images", y, "--out", "nowhere",
                                        "--model", "tiny-test"]),
             lambda: dino_extract.main(["--images", y, "--out", "nowhere",
                                        "--model", "dino_vits8"]),
             lambda: clip_extract.main(["--images", y, "--out", "nowhere",
                                        "--clip-model", "tiny-test"]),
             lambda: stage_scene(z[..., None].repeat(3, -1), z, z, np.eye(4),
                                 np.eye(3)),
             lambda: preprocess_data.main(["-ds", "Blender", "-r", empty_raw,
                                           "-c", empty_raw]),
             lambda: cleanup.plane_removal(np.eye(3)),
             lambda: cleanup.remove_stat_outlier(np.eye(3)),
             lambda: cleanup.pc_outlier_removal(np.eye(3)),
             lambda: train_main(["--config", "configs/DistilBlender.yaml"])):
    try:
        make()
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("entry point ran without a card")
GroundingPipeline(cfg, clip_sim=make_clip_sim(cfg, device="cpu"),
                  device="cpu")
GroundingPipeline(pcfg, device="cpu")
build_clip("tiny-test", device="cpu")
build_clip("tiny-test-rn", device="cpu")
build_dinov2("tiny-test", device="cpu")
ViTExtractor("tiny-test", device="cpu")
import tempfile
from dropclip_tpu_torch.core.config import load_cfg
from dropclip_tpu_torch.data import build_dataset_for
from dropclip_tpu_torch.data.synthetic import write_fake_processed_dataset
with tempfile.TemporaryDirectory() as tmp:
    write_fake_processed_dataset(tmp, n_scenes=1, fmt="npz")
    dcfg = load_cfg("configs/DistilBlender.yaml")
    dcfg.update(root_dir=tmp, voxel_capacity=256, voxel_size=0.02)
    train, val, collate = build_dataset_for(dcfg)
    assert collate([train[0], val[0]])["coords"].shape == (2, 256, 3)
from dropclip_tpu_torch.data import rle, scene_io
m = (np.arange(48 * 64).reshape(48, 64) % 7 == 0).astype(np.uint8)
assert (rle.decode_rle(rle.encode_rle(m)) == m).all()
with tempfile.TemporaryDirectory() as tmp:
    f = np.ones((40, 3), np.float32) * np.arange(40)[:, None] / 40
    lab = np.arange(40) % 2 + 1
    for split in ("train", "seen_val"):
        scene_io.write_regrad_scene(
            os.path.join(tmp, split, "s1.npz"), f, f, lab,
            np.ones((40, 8), np.float32), np.ones((2, 8), np.float32),
            np.array([1, 2]))
    rcfg = load_cfg("configs/DistilREGRAD.yaml")
    rcfg.update(processed_dir=tmp, voxel_capacity=64)
    train, val, collate = build_dataset_for(rcfg)
    assert collate([train[0], val[0]])["targets"].shape == (2, 64, 8)
print("OK", len(mods))
"""


def test_imports_without_jax_yaml_regex_triton():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 75  # every module of the package was imported


def test_no_forbidden_imports_in_sources():
    """No module of the port nor a script that runs on the card
    (chip_smoke.py and the timing and readings scripts beside it) names a
    forbidden package in an import statement; h5py only inside a function
    (the scene writer's, which the card's machine never calls)."""
    import re

    pat = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|"
                     r"dropclip_tpu\b|regex|yaml)|^(?:import|from)\s+h5py",
                     re.M)
    files = [os.path.join(ROOT, n) for n in (
        "chip_smoke.py", "attention_timing.py", "brick_conv_timing.py",
        "brick_conv_variants.py", "pillar_conv_timing.py",
        "layernorm_timing.py", "train_grad_readings.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dropclip_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
