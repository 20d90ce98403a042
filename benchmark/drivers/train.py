"""Closed loop of the distillation trainer's step (``distill/engine.
make_train_step`` over ``AmsgradChain``) on a ring of batches staged on
the card at set-up.

Set-up builds the one training state, from weights the benchmark draws,
and drives it through its first steps, one pass over the ring, the
first three of which the reference follows. The window then steps on
around the ring until ``--seconds`` have passed, and closes with one
synchronisation: ``train_scenes_per_s`` is every scene of every step it
ran over its wall time. A step whose loss is not finite or whose
topology dropped a voxel counts as failed. Once the window is closed and
the program's state freed, the plain reference repeats the first three
steps from the same weights and batches, and the run compares each
step's loss, the first gradient as the optimizer took it (from its first
moment after one step), the change of every weight over the three steps
and the batch norms' running statistics, each by its worst leaf. A
stand-in (``STAND_INS``: the control, a planted fault) takes the
program's place in that comparison for calibration and tests."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import counting, gen, trace, weights
from ..reference import minkunet as ref
from ..reference.optim import B1, Amsgrad


def arch_of(config: Dict) -> Dict:
    return {k: config[k] for k in ("planes", "layers", "init_dim",
                                   "in_channels", "feat_dim")}


def recipe_of(config: Dict, traffic: Dict) -> Dict:
    r = {k: config[k] for k in ("base_lr", "min_lr", "weight_decay",
                                "max_norm", "epochs")}
    r["iters_per_epoch"] = traffic["iters_per_epoch"]
    return r


def program_cfg(config: Dict):
    """The program's configuration node, as the trainer reads it, from
    the configuration file's keys."""
    from dropclip_tpu_torch.core.config import CfgNode

    if config["student_dtype"] != "float32":
        raise ValueError(f"student_dtype {config['student_dtype']!r}: the "
                         "program's student runs float32 only")
    keys = ("arch_3d", "feat_dim", "voxel_size", "voxel_capacity",
            "brick_shape", "base_lr", "min_lr", "weight_decay", "max_norm",
            "epochs", "loss_type", "batch_size", "planes", "layers",
            "init_dim", "use_color", "remat", "sparse_backend")
    cfg = CfgNode({k: config[k] for k in keys})
    cfg.update(dropout_rate=0.0, use_aux_loss=False, use_cls_head=False)
    return cfg


def make_ring(run, device) -> Dict:
    """The ring of batches from the seed: scenes (the same sizes for
    every seed), xyz+rgb inputs, random unit targets; on ``device``."""
    cfg, tr = run.config, run.traffic
    bsz, n = int(cfg["batch_size"]), int(tr["ring"])
    cap, vs = int(cfg["voxel_capacity"]), float(cfg["voxel_size"])
    rng = gen.rng_for(run.seed, 1)
    scenes = gen.make_scenes(tr["scenes"], bsz * n, rng)
    coords, mask = gen.padded(scenes, cap)
    xyz = (coords + rng.random(coords.shape)) * vs
    xyz -= (xyz * mask[..., None]).sum(1, keepdims=True) / mask.sum(
        1)[:, None, None]
    feats = np.concatenate([xyz, rng.random(coords.shape)], -1)
    feats = (feats * mask[..., None]).astype(np.float32)
    g = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))
    tgt = torch.randn((bsz * n, cap, int(cfg["feat_dim"])), generator=g,
                      device=device)
    tgt = tgt / tgt.norm(dim=-1, keepdim=True)
    m = torch.as_tensor(mask, device=device)
    tgt = tgt * m[..., None]
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dict(scenes=scenes, coords=coords, mask=mask,
                batches=[(put(coords[i * bsz:(i + 1) * bsz]),
                          m[i * bsz:(i + 1) * bsz],
                          put(feats[i * bsz:(i + 1) * bsz]),
                          tgt[i * bsz:(i + 1) * bsz]) for i in range(n)])


def batch_work(config: Dict, ring: Dict) -> List[Dict]:
    """Per ring batch, the train step's work: every conv's forward,
    input and weight gradient (the stem's input takes none), and K1's
    forward and input gradient of the k3 convs."""
    arch, bsz = arch_of(config), int(config["batch_size"])
    out = []
    for i in range(len(ring["batches"])):
        st = counting.level_stats(ring["scenes"][i * bsz:(i + 1) * bsz])
        w = counting.student_work(arch, st)
        stem, _ = counting.conv_work(counting.unet_convs(arch)[0], st)
        out.append(dict(model_flops=3 * w["flops"] - stem,
                        k1_flops=2 * w["k3_flops"],
                        k1_bytes=2 * w["k3_bytes"],
                        k1_launches=2 * w["k3_convs"]))
    return out


def reference_steps(run, w0: Dict[str, torch.Tensor], batches,
                    precision: str = "float32") -> Dict:
    """The plain reference's first three steps from ``w0``: losses, the
    first clipped gradient, weights and running statistics after three.
    ``precision`` "tf32" computes the products in TF32 (the control)."""
    arch, recipe = arch_of(run.config), recipe_of(run.config, run.traffic)
    tf32 = precision == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in w0.items()
                  if k.endswith((".kernel", ".scale", ".bias"))}
        stats = {k: v.detach().clone() for k, v in w0.items()
                 if k not in leaves}
        opt = Amsgrad(leaves, recipe)
        losses, grad1 = [], None
        for i, (coords, mask, feats, tgt) in enumerate(batches[:3]):
            pyr = ref.Pyramid(coords, mask)
            norms = ref.Norms({**leaves, **stats}, training=True)
            out = ref.forward({**leaves, **stats}, arch, pyr, feats, norms)
            loss = ref.cosine_loss(out, tgt, mask)
            for v in leaves.values():
                v.grad = None
            loss.backward()
            grads, _ = opt.step(leaves)
            if i == 0:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            for name, (mean, var) in norms.moved.items():
                stats[f"{name}.mean"], stats[f"{name}.var"] = mean, var
            losses.append(float(loss.detach()))
            del pyr, norms, out, loss
        return dict(losses=losses, grad1=grad1,
                    params={k: v.detach() for k, v in leaves.items()},
                    stats=stats)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _norms(d: Dict[str, torch.Tensor], base=None) -> Dict[str, float]:
    return {k: float((v.double() - (0 if base is None else
                                    base[k].double())).norm())
            for k, v in d.items()}


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               keys=None) -> float:
    """The largest gap between two norms of a leaf, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    keys = list(want) if keys is None else list(keys)
    med = float(np.median([want[k] for k in keys]))
    gaps = [abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys]
    return float(np.nan_to_num(np.max(gaps), nan=np.inf))


def compare(w0: Dict, prog: Dict, refr: Dict) -> Dict[str, float]:
    """The four numbers, program (or control) against the reference.
    Leaves whose first reference gradient is below a thousandth of the
    median leaf's move under AMSGrad by round-off alone, and are left
    out of the change."""
    g_ref = _norms(refr["grad1"])
    med = float(np.median(list(g_ref.values())))
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    loss = float(np.nan_to_num(np.max([
        abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                            refr["losses"])]), nan=np.inf))
    return dict(
        loss_gap=loss,
        grad_gap=worst_leaf(_norms(prog["grad1"]), g_ref),
        change_gap=worst_leaf(_norms(prog["params"], w0),
                              _norms(refr["params"], w0), moved),
        stats_gap=worst_leaf(_norms(prog["stats"], w0),
                             _norms(refr["stats"], w0)))


def program_first_steps(state, step, feed, n_steps: int):
    """Set-up's steps through the window's own call and feed: (what the
    comparison takes from the first three, every step's metrics)."""
    model, opt = state.model, state.opt_state
    got, metrics = dict(losses=[]), []
    for i in range(n_steps):
        state, out = step(state, feed[i % len(feed)])
        metrics.append(out)
        if i < 3:
            got["losses"].append(out["distil_loss"])
        if i == 0:
            got["grad1"] = {k: st["mu"].detach().clone() / (1 - B1)
                            for k, st in opt["moments"].items()}
        if i == 2:
            got["params"] = {k: p.detach().clone()
                             for k, p in model.named_parameters()}
            got["stats"] = {k: b.detach().clone()
                            for k, b in model.named_buffers()}
    got["losses"] = [float(v) for v in got["losses"]]
    return got, metrics


def build(run) -> Dict:
    """Set-up: the ring, the weights, and the one training state with
    its step, the brick capacities fitted over the ring as a user fits
    them (slack from the traffic)."""
    from dropclip_tpu_torch.distill.engine import (DistilBatch,
                                                   build_student_for,
                                                   make_train_step)
    from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                        make_optimizer)
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    dev = run.device
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as configured
    torch.backends.cudnn.allow_tf32 = False
    cfg = program_cfg(run.config)
    ring = make_ring(run, dev)
    if cfg.sparse_backend == "bricks":
        cfg.brick_capacities = list(autotune_brick_capacities(
            ring["coords"], ring["mask"], slack=float(run.traffic["slack"]),
            brick_shape=tuple(run.config["brick_shape"])))
    w0 = weights.draw(ref.weight_shapes(arch_of(run.config)),
                      weights.student_init, run.seed, dev)
    model = build_student_for(cfg)
    model.load_state_dict(w0)
    model.to(dev)
    state = create_train_state(
        model, make_optimizer(cfg, int(run.traffic["iters_per_epoch"])))
    batches = ring["batches"]
    z = torch.zeros_like(batches[0][1], dtype=torch.int32)
    return dict(ring=ring, w0=w0, state=state, step=make_train_step(cfg),
                feed=[DistilBatch(c, m, f, t, z, z)
                      for c, m, f, t in batches])


def free() -> None:
    """Collect what the caller let go (the program's state) and hand its
    memory back, before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def half_batch(batches):
    """A planted fault: the second half of each batch's scenes left out,
    the loss's mean taken over the rest."""
    out = []
    for c, m, f, t in batches:
        m = m.clone()
        m[m.shape[0] // 2:] = False
        out.append((c, m, f, t))
    return out


# controls and planted faults that the comparison can judge in the
# program's place: each gives what the comparison takes from the program
STAND_INS = {
    "control_tf32": lambda run, w0, batches: reference_steps(
        run, w0, batches, "tf32"),
    "fault_half_batch": lambda run, w0, batches: reference_steps(
        run, w0, half_batch(batches)),
}


def run(run) -> None:
    from dropclip_tpu_torch.kernels.brick_conv3 import counter

    dev = run.device
    b = build(run)
    state, step, feed = b["state"], b["step"], b["feed"]
    batches, w0 = b["ring"]["batches"], b["w0"]
    got, first = program_first_steps(state, step, feed,
                                     max(3, len(feed)))
    for out in first:
        if not torch.isfinite(out["distil_loss"]) or out["dropped_voxels"]:
            raise RuntimeError("a set-up step dropped voxels or lost its "
                               "loss: the traffic does not fit the cell")
    run.setup_done()

    k, outs = len(first), []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        state, out = step(state, feed[k % len(feed)])
        outs.append((out["distil_loss"], out["dropped_voxels"]))
        k += 1
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run.e2e["train_scenes_per_s"] = len(outs) * feed[0].mask.shape[0] / wall
    run.attempted = len(outs)
    run.failed = sum(1 for loss, drop in outs
                     if not torch.isfinite(loss) or int(drop))

    if run.trace:
        work = batch_work(run.config, b["ring"])
        run.work["window_flops"] = sum(
            work[i % len(feed)]["model_flops"]
            for i in range(len(first), len(first) + len(outs)))
        run.work["window_s"] = wall
        at = [k]

        def unit():
            i = at[0] % len(feed)
            step(state, feed[i])
            at[0] += 1
            return i

        run.probe = trace.counted_profile(
            unit, int(run.traffic["profile_steps"]),
            lambda: counter.launches, lambda n: "brick_conv3" in n)
        for key in ("k1_flops", "k1_bytes"):
            run.work[key] = sum(work[i][key] for i in run.probe.units)
        run.work["dtype"] = run.config["student_dtype"]
    if dev == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()
    del b, state, step, feed, outs, first
    free()
    if run.stand_in is not None:
        got = STAND_INS[run.stand_in](run, w0, batches)
    refr = reference_steps(run, w0, batches)
    run.compare(compare(w0, got, refr))
