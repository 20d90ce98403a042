"""The brick engine's three row gathers (``sparse/bricks.py``: the down
conv's children, the up conv's octant sub-blocks, the points' voxel
slots) take a backward that reads through the topology's inverse maps
where autograd records them. Held here to autograd's backward of the
plain indexing they replace (copied below as the reference), in float64
on folded batches with padded points, with bricks a small capacity
drops, and with two points on one voxel; and, in a training step of the
tiny student, to the same parameter gradients with no
``IndexBackward0`` node, and a ``no_grad`` forward that runs the plain
indexing op for op (``tests/test_torch_spans.py`` counts the backwards'
spans in a training step)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.core.spans import PREFIX
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.distill.engine import build_student_for, build_topology
from dropclip_tpu_torch.sparse import bricks as tb
from dropclip_tpu_torch.sparse import unet_bricks


# ------------------------------------------------ the plain reference

def plain_down(fine_feats, group_map, coarse, weights, *_):
    _, bx, by, bz, cin = fine_feats.shape
    cout = weights.shape[-1]
    bmc = group_map.shape[0]
    fz = torch.cat([fine_feats, fine_feats.new_zeros((1, bx, by, bz, cin))])
    grp = fz[group_map.long()]
    grp = grp.reshape(bmc, 2, 2, 2, bx, by, bz, cin).permute(
        0, 1, 4, 2, 5, 3, 6, 7)
    grp = grp.reshape(bmc, bx, 2, by, 2, bz, 2, cin).permute(
        0, 1, 3, 5, 2, 4, 6, 7).reshape(bmc * bx * by * bz, 8 * cin)
    out = grp @ weights.to(grp.dtype).reshape(8 * cin, cout)
    out = out.reshape(bmc, bx, by, bz, cout)
    return out * coarse.occ[..., None].to(out.dtype)


def plain_up(coarse_feats, parent_map, octant, fine, weights, *_):
    bmc, bx, by, bz, cin = coarse_feats.shape
    cout = weights.shape[-1]
    cz = torch.cat([coarse_feats,
                    coarse_feats.new_zeros((1, bx, by, bz, cin))])
    par = cz[torch.clamp(parent_map.long(), max=bmc)]

    def pick(t, bit, axis):
        half = t.shape[axis] // 2
        lo, hi = t.narrow(axis, 0, half), t.narrow(axis, half, half)
        return torch.where(bit.reshape((-1,) + (1,) * (t.dim() - 1)), hi, lo)

    sub = pick(par, octant[:, 0].bool(), 1)
    sub = pick(sub, octant[:, 1].bool(), 2)
    sub = pick(sub, octant[:, 2].bool(), 3)
    up = torch.einsum("bxyzc,kcd->bxyzkd", sub, weights.to(sub.dtype))
    up = up.reshape(-1, bx // 2, by // 2, bz // 2, 2, 2, 2, cout)
    up = up.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(-1, bx, by, bz, cout)
    return up * fine.occ[..., None].to(up.dtype)


def plain_points(dense, row, within):
    bm, bx, by, bz, c = dense.shape
    bv = bx * by * bz
    flat = torch.cat([dense.reshape(bm * bv, c), dense.new_zeros((1, c))])
    row, within = row.long(), within.long()
    src = torch.where(row < bm, row * bv + within, bm * bv)
    return flat[src]


def use_plain(mp):
    """Route the student's three gathers to the plain reference."""
    mp.setattr(unet_bricks, "brick_down_conv", plain_down)
    mp.setattr(unet_bricks, "brick_up_conv", plain_up)
    mp.setattr(unet_bricks, "gather_points", plain_points)


# --------------------------------------------------------- the gathers

BSHAPES = [(2, 2, 2), (4, 4, 2)]
# padded: autotuned capacities, padded points past each scene's voxels;
# dropped: two thirds of each level's bricks kept (points on a dropped
# brick, fine bricks whose parent is cut); shared: two masked
# points on one voxel of each scene
CASES = ["padded", "dropped", "shared"]


# (device, dtype, batch, points, voxels a scene, coordinate extent): the
# CPU in float64 at the tiny size; the card in float32, the student's
# dtype, at a tabletop scene's size
SIZES = {"cpu": ("cpu", torch.float64, 2, 256, 180, 10),
         "cuda": ("cuda", torch.float32, 4, 8192, 6000, 40)}


def folded(bshape, case, size="cpu", seed=0):
    dev, _, batch, m, n_occ, ext = SIZES[size]
    coords, mask = make_tabletop_coords(np.random.RandomState(seed), batch,
                                        m, n_occ=n_occ, ext=ext)
    assert not mask.all()
    if case == "shared":
        coords[:, 1] = coords[:, 0]
    caps = tb.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    if case == "dropped":
        worst = tb.autotune_brick_capacities(coords, mask, slack=1.0,
                                             multiple=1, floor=1,
                                             brick_shape=bshape)
        caps = tuple(max(c * 2 // 3, 1) for c in worst)
    topo = tb.build_brick_topology(
        torch.as_tensor(coords, device=dev), torch.as_tensor(mask, device=dev),
        grid_bits=6, brick_capacities=caps, brick_shape=bshape)
    assert int(topo.dropped[:, 0].sum()) == 0 or case == "dropped"
    if case == "dropped":
        cut = topo.dropped.sum(0)
        assert cut[0] > 0 and cut[1] > 0 and cut[2:].sum() > 0
    return tb.fold_topology(topo)


def leaf(rng, shape, size="cpu"):
    dev, dtype = SIZES[size][:2]
    return torch.as_tensor(rng.randn(*shape), dtype=dtype,
                           device=dev).requires_grad_()


def grads(fn, x, seed):
    out = fn()
    g = torch.as_tensor(np.random.RandomState(seed).randn(*out.shape),
                        dtype=out.dtype, device=out.device)
    return out, torch.autograd.grad(out, x, g)[0], out.grad_fn


def index_nodes(grad_fn):
    """The ``IndexBackward0`` nodes of an autograd graph."""
    seen, stack, found = set(), [grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "IndexBackward0":
            found.append(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return found


@pytest.mark.parametrize("gather", ["down", "up", "points"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bshape", BSHAPES, ids=str)
@pytest.mark.parametrize("size", ["cpu", pytest.param("cuda",
                                                      marks=pytest.mark.cuda)])
def test_gather_backward_equals_autograd_of_plain_indexing(size, bshape, case,
                                                           gather):
    """Outputs and input gradients equal bit for bit: each source row
    takes one gradient, or two on a shared voxel, whose sum is the same
    in either order."""
    if size == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the gathers at a scene's size")
    t = folded(bshape, case, size)
    rng = np.random.RandomState(1)
    lv = t.levels
    calls = []
    if gather == "points":
        x = leaf(rng, tuple(lv[0].occ.shape) + (5,), size)
        calls.append((lambda: tb.gather_points(x, t.point_row,
                                               t.point_within),
                      lambda: plain_points(x, t.point_row, t.point_within),
                      x))
    for l in range(len(lv) - 1) if gather != "points" else ():
        w = leaf(rng, (8, 3, 4), size).detach()
        if gather == "down":
            x = leaf(rng, tuple(lv[l].occ.shape) + (3,), size)
            args = (x, t.group_maps[l], lv[l + 1], w)
            new = (lambda a=args, l=l: tb.brick_down_conv(
                *a, t.parent_maps[l], t.octants[l]))
            old = (lambda a=args: plain_down(*a))
        else:
            x = leaf(rng, tuple(lv[l + 1].occ.shape) + (3,), size)
            args = (x, t.parent_maps[l], t.octants[l], lv[l], w)
            new = (lambda a=args, l=l: tb.brick_up_conv(*a, t.group_maps[l]))
            old = (lambda a=args: plain_up(*a))
        calls.append((new, old, x))
    for new, old, x in calls:
        got, g_got, fn = grads(new, x, 2)
        ref, g_ref, _ = grads(old, x, 2)
        assert torch.equal(got, ref)
        assert torch.equal(g_got, g_ref)
        assert g_got.abs().sum() > 0
        assert index_nodes(fn) == []


def test_points_backward_sums_points_on_one_voxel():
    """Two masked points on one voxel: the slot's gradient is the sum of
    both points' gradients; padded points add nothing anywhere."""
    t = folded((4, 4, 2), "shared")
    x = leaf(np.random.RandomState(3), tuple(t.levels[0].occ.shape) + (2,))
    out = tb.gather_points(x, t.point_row, t.point_within)
    g = torch.ones_like(out)
    (gx,) = torch.autograd.grad(out, x, g)
    row, within = t.point_row.long(), t.point_within.long()
    bm, bx, by, bz, _ = x.shape
    hit = row < bm
    slots = (row * (bx * by * bz) + within)[hit]
    want = torch.zeros(x.numel() // 2, dtype=torch.float64)
    want.index_add_(0, slots, torch.ones(len(slots), dtype=torch.float64))
    assert want.max() == 2
    assert torch.equal(gx.reshape(-1, 2)[:, 0], want)


# ------------------------------------------------------- the student

CFG = dict(arch_3d="tiny", feat_dim=16, in_channels=6, use_color=True,
           sparse_backend="bricks", remat=False, use_cls_head=False)


def student_step(bshape, seed=4, remat=False):
    cfg = CfgNode(dict(CFG, brick_shape=list(bshape), remat=remat))
    model = build_student_for(cfg, generator=torch.Generator().manual_seed(5))
    model.train()
    coords, mask = make_tabletop_coords(np.random.RandomState(seed), 2, 192,
                                        n_occ=120, ext=8, n_blobs=2)
    topo = build_topology(cfg, torch.as_tensor(coords),
                          torch.as_tensor(mask))
    rng = np.random.RandomState(seed + 1)
    x = torch.as_tensor((rng.randn(2, 192, 6) * mask[..., None]).astype(
        np.float32))
    g = torch.as_tensor(rng.randn(2, 192, 16).astype(np.float32))
    return model, topo, x, g


def param_grads(bshape, remat=False):
    model, topo, x, g = student_step(bshape, remat=remat)
    out = model(topo, x)
    loss = (out * g).sum()
    loss.backward()
    return ([p.grad.clone() for p in model.parameters()],
            index_nodes(out.grad_fn))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("bshape", BSHAPES, ids=str)
def test_student_parameter_gradients_unchanged(bshape, remat, monkeypatch):
    got, nodes = param_grads(bshape, remat)
    assert nodes == []
    with monkeypatch.context() as mp:
        use_plain(mp)
        ref, ref_nodes = param_grads(bshape, remat)
    # the plain indexing's backward: 4 down, 4 up, 1 points
    assert len(ref_nodes) == 9
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def traced(fn):
    """(aten op names in order, count of gather-backward spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns())
    names = [e.name() for e in events]
    return ([n for n in names if n.startswith("aten::")],
            names.count(PREFIX + "bricks.gather_backward"))


def test_no_grad_forward_runs_the_plain_indexing(monkeypatch):
    model, topo, x, _ = student_step((4, 4, 2))
    with torch.no_grad():
        ops, n = traced(lambda: model(topo, x))
        assert n == 0
        with monkeypatch.context() as mp:
            use_plain(mp)
            ref_ops, _ = traced(lambda: model(topo, x))
    assert ops == ref_ops
