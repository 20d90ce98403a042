"""The plain references against toys checked by hand, and against the
program on the CPU at a tiny size."""

import math

import numpy as np
import pytest
import torch

from benchmark import gen, weights
from benchmark.reference import clip_text, grounding, minkunet, optim


def test_submanifold_conv_by_hand():
    """Two voxels one apart in x: each sees itself (centre tap 13) and
    the other (tap 4 for -x, tap 22 for +x)."""
    coords = torch.tensor([[[0, 0, 0], [1, 0, 0]]])
    pyr = minkunet.Pyramid(coords, torch.ones(1, 2, dtype=torch.bool), 1)
    w = torch.zeros(27, 1, 1)
    w[13], w[4], w[22] = 1.0, 10.0, 100.0
    x = torch.tensor([[2.0], [3.0]])
    out = minkunet.submanifold(x, pyr.k3[0], w)
    # voxel 0 reads +x (3, tap 22); voxel 1 reads -x (2, tap 4)
    assert out[:, 0].tolist() == [2 + 100 * 3, 3 + 10 * 2]


def test_down_and_up_by_hand():
    coords = torch.tensor([[[0, 0, 0], [1, 0, 1], [-1, 0, 0]]])
    pyr = minkunet.Pyramid(coords, torch.ones(1, 3, dtype=torch.bool), 2)
    fine, coarse = pyr.levels
    assert coarse.coords.tolist() == [[-1, 0, 0], [0, 0, 0]]
    w = torch.arange(8, dtype=torch.float32).view(8, 1, 1) + 1
    x = torch.ones(3, 1)
    down = minkunet.down(x, pyr.parent[0], pyr.octant[0], 2, w)
    # (-1,0,0) is child 4 (x odd) of (-1,0,0); (0,0,0) child 0 and
    # (1,0,1) child 5 of (0,0,0)
    assert down[:, 0].tolist() == [5.0, 1.0 + 6.0]
    up = minkunet.up(torch.tensor([[1.0], [2.0]]), pyr.parent[0],
                     pyr.octant[0], w)
    got = {tuple(c): float(v) for c, v in zip(fine.coords.tolist(), up[:, 0])}
    assert got == {(-1, 0, 0): 5.0, (0, 0, 0): 2.0, (1, 0, 1): 12.0}


def test_batch_norm_statistics_by_hand():
    w = {"n.scale": torch.ones(1), "n.bias": torch.zeros(1),
         "n.mean": torch.zeros(1), "n.var": torch.ones(1)}
    norms = minkunet.Norms(w, training=True)
    y = norms("n", torch.tensor([[1.0], [3.0]]))
    assert y[:, 0].tolist() == pytest.approx([-1.0, 1.0], abs=1e-4)
    mean, var = norms.moved["n"]
    assert float(mean) == pytest.approx(0.2)
    assert float(var) == pytest.approx(0.9 + 0.1 * 2.0)  # unbiased 2


def test_amsgrad_first_step_by_hand():
    p = torch.tensor([1.0, -1.0], requires_grad=True)
    recipe = dict(base_lr=0.1, min_lr=0.0, weight_decay=0.0, max_norm=5.0,
                  epochs=10, iters_per_epoch=100)
    opt = optim.Amsgrad({"p": p}, recipe)
    p.grad = torch.tensor([0.5, -2.0])
    grads, norm = opt.step({"p": p})
    assert norm == pytest.approx(math.sqrt(4.25))
    # first AMSGrad step: mu_hat / sqrt(nu_hat) = sign(g) at rate 0.1
    assert p.tolist() == pytest.approx([0.9, -0.9], abs=1e-6)
    p.grad = torch.tensor([30.0, 40.0])  # norm 50: clipped to 5
    grads, _ = opt.step({"p": p})
    assert grads["p"].tolist() == pytest.approx([3.0, 4.0])


def test_sgdr_by_hand():
    assert optim.sgdr(0, 0.3, 0.1, 200, 10) == pytest.approx(0.3)
    assert optim.sgdr(1000, 0.3, 0.1, 200, 10) == pytest.approx(0.2)


def test_paired_scores_by_hand():
    feats = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
    pos = torch.tensor([[1.0, 0.0]])
    neg = torch.tensor([[0.0, 1.0]])
    s = grounding.paired_scores(feats, pos, neg)
    # raw: e^10 / (e^10 + e^0), e^0 / (e^0 + e^10), 0 for the zero row
    raw = [1 / (1 + math.exp(-10)), 1 / (1 + math.exp(10)), 0.0]
    lo, hi = min(raw), max(raw)
    assert s[0].tolist() == pytest.approx([(r - lo) / (hi - lo)
                                           for r in raw])


def test_voxelize_by_hand():
    xyz = np.array([[0.01, 0, 0], [0.02, 0, 0], [0.12, 0, 0]], np.float32)
    coords, feats, inv = grounding.voxelize(xyz, np.eye(3, dtype=np.float32),
                                            0.05)
    # centred on x = 0.05: -0.04, -0.03 in voxel -1, 0.07 in voxel 1
    assert coords[:, 0].tolist() == [-1, 1] and inv.tolist() == [0, 0, 1]
    assert feats[0, 3:].tolist() == [1, 0, 0]  # the first point's rgb


def test_tokenizer_by_hand():
    tok = clip_text.Tokenizer(
        "dropclip_tpu_torch/teachers/assets/bpe_simple_vocab_16e6.txt.gz")
    ids = tok(["a mug"])[0]
    assert ids[0] == 49406 and ids[3] == 49407 and ids[4:].sum() == 0
    assert tok(["A  mug"]).tolist() == tok(["a mug"]).tolist()


def test_student_matches_the_program_on_the_cpu():
    """The reference MinkUNet and the program's brick student, same
    weights and tiny scenes, in eval and in training (loss, gradients,
    running statistics)."""
    from dropclip_tpu_torch.core.config import CfgNode
    from dropclip_tpu_torch.distill.engine import (build_student_for,
                                                   build_topology)
    from dropclip_tpu_torch.distill.loss import cosine_distil_loss
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    arch = dict(planes=(4, 4, 8, 8, 8, 8, 4, 4), layers=(1,) * 8,
                init_dim=8, in_channels=6, feat_dim=16)
    scenes = gen.make_scenes({"shape": "tabletop", "voxels": [150, 250],
                              "ext": 10}, 2, gen.rng_for(5, 0))
    coords, mask = gen.padded(scenes, 256)
    cfg = CfgNode(dict(arch_3d="tiny", feat_dim=16, use_color=True,
                       brick_shape=[4, 4, 2], remat=False, init_dim=8))
    cfg.brick_capacities = list(autotune_brick_capacities(
        coords, mask, slack=1.5, brick_shape=(4, 4, 2)))
    w = weights.draw(minkunet.weight_shapes(arch), weights.student_init, 3,
                     "cpu")
    model = build_student_for(cfg)
    model.load_state_dict(w)
    c, m = torch.as_tensor(coords), torch.as_tensor(mask)
    x = torch.randn(2, 256, 6, generator=torch.Generator().manual_seed(0))
    x = x * m[..., None]
    tgt = torch.randn(2, 256, 16, generator=torch.Generator().manual_seed(1))
    for training in (False, True):
        model.train(training)
        out = model(build_topology(cfg, c, m), x)
        leaves = {k: v.clone().requires_grad_(not k.endswith((".mean",
                                                              ".var")))
                  for k, v in w.items()}
        norms = minkunet.Norms(leaves, training)
        ref = minkunet.forward(leaves, arch, minkunet.Pyramid(c, m), x, norms)
        scale = float(ref.detach().abs().max())
        assert float((out - ref).detach().abs().max()) <= 1e-5 * scale
    cosine_distil_loss(out, tgt, m).backward()
    minkunet.cosine_loss(ref, tgt, m).backward()
    for name, p in model.named_parameters():
        g = leaves[name].grad
        assert float((p.grad - g).abs().max()) <= 1e-3 * float(
            g.abs().max()) + 1e-7, name
    for name, b in model.named_buffers():
        key, stat = name.rsplit(".", 1)
        want = norms.moved[key][0 if stat == "mean" else 1]
        assert torch.allclose(b, want, rtol=1e-5, atol=1e-6), name
