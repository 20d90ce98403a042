"""The port's yaml-free config reader against PyYAML and the JAX loader."""

import glob
import os

import pytest
import yaml

from dropclip_tpu.core import config as jcfg
from dropclip_tpu_torch.core import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = tcfg.load_yaml(path)
    assert got == ref
    # types too (True vs 1, 1e-05 float, "0,3,15" str)
    flat = lambda d: [(s, k, type(v)) for s, b in d.items()
                      for k, v in (b.items() if isinstance(b, dict)
                                   else [(None, b)])]
    assert flat(got) == flat(ref)


def test_four_configs_present():
    assert len(CONFIGS) == 4


def test_load_cfg_and_overrides_match_jax():
    path = os.path.join(ROOT, "configs", "DistilBlender.yaml")
    a, b = jcfg.load_cfg(path), tcfg.load_cfg(path)
    assert dict(a) == dict(b)
    opts = ["feat_dim", "16", "MODEL.brick_shape", "[4, 4, 4]",
            "use_color", "False", "voxel_size", "0.1", "new_key", "x"]
    assert dict(jcfg.merge_cfg_from_list(a, opts)) == dict(
        tcfg.merge_cfg_from_list(b, opts))
    assert b.arch_3d == "MinkUNet14D" and b.brick_shape == [4, 4, 2]
    assert b.missing_flag is None


@pytest.mark.parametrize("text", [
    "a: 1e5\nb: 1.0e+3\nc: 0x1F\nd: 017\ne: 'it''s'\nf: \"x#y\"  # c\n",
    "g:\n  - 1\n  - [a, b]\nh: ~\ni: .inf\nj: yes\nk: 0b101\nl: 1_000\n",
    "top:\n  nested:\n    deep: Off\n  empty:\nm: -.5\nn: \"tab\\t\"\n",
])
def test_scalar_resolution_matches_pyyaml(text):
    assert tcfg._parse_yaml(text) == yaml.safe_load(text)


def test_unsupported_constructs_raise():
    with pytest.raises(ValueError):
        tcfg._parse_yaml("a: &anchor 1\n")
    with pytest.raises(ValueError):
        tcfg._parse_yaml("a: {b: 1}\n")
