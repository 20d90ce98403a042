"""dropclip_tpu_torch imports with none of jax, flax, the JAX package,
regex, yaml, h5py or triton available (the card's machine has only torch,
triton, numpy, scipy, einops, pytest and hypothesis), and its entry points
(serve pipeline, text encoder, CLIP, ingest staging) refuse to run without
a card unless asked for the CPU."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "dropclip_tpu",
             "regex", "yaml", "h5py", "triton"):
    sys.modules[name] = None  # any import of these raises ImportError
import importlib, pkgutil
import dropclip_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(n for n in ("jax", "flax", "dropclip_tpu", "regex", "yaml",
                            "h5py", "triton") if sys.modules.get(n) is not None)
assert not leaked, leaked
import torch
torch.cuda.is_available = lambda: False
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.pipeline import GroundingPipeline, make_clip_sim
cfg = CfgNode(dict(arch_3d="tiny", feat_dim=8, voxel_capacity=64,
                   sparse_backend="bricks", clip_checkpoint="random",
                   clip_model="tiny-test"))
from dropclip_tpu_torch.teachers.clip import build_clip
from dropclip_tpu_torch.tools.preprocess_data import stage_scene
import numpy as np
z = np.zeros((1, 4, 4), np.float32)
for make in (lambda: GroundingPipeline(cfg), lambda: make_clip_sim(cfg),
             lambda: build_clip("tiny-test"),
             lambda: stage_scene(z[..., None].repeat(3, -1), z, z, np.eye(4),
                                 np.eye(3))):
    try:
        make()
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("entry point ran without a card")
GroundingPipeline(cfg, clip_sim=make_clip_sim(cfg, device="cpu"),
                  device="cpu")
build_clip("tiny-test", device="cpu")
print("OK", len(mods))
"""


def test_imports_without_jax_yaml_regex_triton():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 34  # every module of the package was imported


def test_no_forbidden_imports_in_sources():
    """No module of the port nor chip_smoke.py names a forbidden package
    in an import statement; h5py only inside a function (the scene
    writer's, which the card's machine never calls)."""
    import re

    pat = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|"
                     r"dropclip_tpu\b|regex|yaml)|^(?:import|from)\s+h5py",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dropclip_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
