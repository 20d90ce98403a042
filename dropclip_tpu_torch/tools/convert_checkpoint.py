"""Convert a reference torch student checkpoint into the port.

Port of ``dropclip_tpu/tools/convert_checkpoint.py``. Loads the
reference's ``.pth`` (reference tools/train_distil.py:255-271 save
format, e.g. the distributed ``best_val_miou_model_fine_tune.pth``,
README.md:29), maps it through ``sparse.convert_student``, and writes
the port trainer's ``.pt`` checkpoint (``core.checkpoint``), which
``GroundingPipeline.from_checkpoint``, ``tools.validate_blender`` and
``tools.train_distil`` (``resume``) read, with ``convert_meta.json``
beside it.

Usage:
  python -m dropclip_tpu_torch.tools.convert_checkpoint \\
      --torch-ckpt best_val_miou_model_fine_tune.pth \\
      --out exp/converted --config configs/DistilBlender.yaml \\
      [--opts feat_dim 768 ...] [--device cpu] \\
      [--offset-order auto --probe-data /path/to/processed]

``--offset-order auto`` converts under both MinkowskiEngine kernel-offset
orders and keeps the one with the lower cosine distillation loss on a
few processed probe scenes (``.h5py`` where h5py is installed, ``.npz``
anywhere): a wrong order loads cleanly and only shows up as scrambled
predictions, so the choice is scored, not assumed. Both scores go to
``convert_meta.json``; a small gap between them means the probe scenes
could not tell the orders apart.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, Sequence

import torch

ORDERS = ("x_fastest", "z_fastest")


def _probe_order_scores(cfg, sd, orders: Sequence[str], probe_root: str,
                        split: str, n_scenes: int, device) -> Dict[str, float]:
    """Mean cosine distillation loss per offset order on probe scenes:
    which kernel permutation makes the converted student reproduce the
    fused teacher features it was distilled against (the scenes'
    ``targets``). The right order scores lower for any trained
    checkpoint; random weights score about 1.0 under both."""
    from ..data.dataset_blender import MVTODDataset
    from ..distill.engine import build_student_for, make_eval_step
    from ..distill.train_state import create_train_state, make_optimizer
    from ..sparse.convert_student import minkowski_student_state_dict
    from .train_distil import to_batch

    probe_cfg = cfg.clone()
    probe_cfg.root_dir = probe_root
    probe_cfg.use_augmentation = False
    ds = MVTODDataset(probe_cfg, split=split, device=device)
    idx = list(range(min(n_scenes, len(ds))))
    if not idx:
        raise SystemExit(f"--probe-data {probe_root}/{split} has no scenes")
    batch = to_batch(MVTODDataset.collate([ds[i] for i in idx]), device)
    model = build_student_for(cfg).to(device)
    state = create_train_state(model, make_optimizer(cfg, 1))
    eval_step = make_eval_step(cfg)
    scores = {}
    for order in orders:
        model.load_state_dict(minkowski_student_state_dict(
            sd, arch=cfg.arch_3d or "MinkUNet14D", offset_order=order))
        _, metrics = eval_step(state, batch)
        scores[order] = float(metrics["distil_loss"])
        print(f"probe[{order}]: distil_loss = {scores[order]:.6f} "
              f"({len(idx)} scenes)")
    return scores


def pick_order(scores: Dict[str, float]) -> str:
    """The order of the lower probe loss; raises on a non-finite score
    (NaN compares False everywhere, so ``min`` would pick blindly)."""
    bad = {k: v for k, v in scores.items() if not math.isfinite(v)}
    if bad:
        raise SystemExit(
            f"--offset-order auto: non-finite probe loss {bad}: the "
            "checkpoint or probe scenes are corrupt; pick the order "
            "explicitly or fix the probe data")
    order = min(scores, key=scores.get)
    lo, hi = sorted(scores.values())
    print(f"auto offset order: {order} (loss {lo:.6f} vs {hi:.6f})")
    if hi - lo < 1e-3:
        print("WARNING: the probe scenes barely discriminate the two "
              "orderings (gap < 1e-3); re-check with more scenes")
    return order


def main(argv=None) -> str:
    """Convert; returns the checkpoint directory."""
    from ..core.checkpoint import LAST_NAME, save_checkpoint
    from ..core.config import load_cfg, merge_cfg_from_list
    from ..core.device import resolve_device
    from ..distill.engine import build_student_for
    from ..distill.train_state import create_train_state, make_optimizer
    from ..sparse.convert_student import minkowski_student_state_dict

    p = argparse.ArgumentParser("dropclip_tpu_torch checkpoint converter")
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--out", required=True, help="checkpoint directory")
    p.add_argument("--config", default="configs/DistilBlender.yaml")
    p.add_argument("--name", default="best_sim_loss_model")
    p.add_argument("--offset-order", default="x_fastest",
                   choices=[*ORDERS, "auto"],
                   help="assumed ME kernel-offset ordering; 'auto' scores "
                        "both on --probe-data and keeps the lower "
                        "distillation loss")
    p.add_argument("--probe-data", default=None,
                   help="processed dataset root for --offset-order auto")
    p.add_argument("--probe-split", default="test")
    p.add_argument("--probe-scenes", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device of the probe (default: the CUDA "
                        "card)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    a = p.parse_args(argv)
    if a.offset_order == "auto" and not a.probe_data:
        p.error("--offset-order auto needs --probe-data (a few processed "
                "scenes to score the two candidate orderings against)")

    cfg = load_cfg(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    arch = cfg.arch_3d or "MinkUNet14D"
    obj = torch.load(a.torch_ckpt, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else \
        obj.state_dict()
    offset_order, scores = a.offset_order, None
    if offset_order == "auto":
        scores = _probe_order_scores(
            cfg, sd, ORDERS, a.probe_data, a.probe_split, a.probe_scenes,
            resolve_device(a.device))
        offset_order = pick_order(scores)

    model = build_student_for(cfg)
    model.load_state_dict(minkowski_student_state_dict(
        sd, arch=arch, offset_order=offset_order))
    state = create_train_state(model, make_optimizer(cfg, 1))
    save_checkpoint(a.out, {"step": 0, "model": model.state_dict(),
                            "opt_state": state.opt_state, "epoch": 0,
                            "best_val": 0.0}, name=a.name)
    # ``train_distil resume`` reads last_model: the same file by that name
    last = os.path.join(a.out, f"{LAST_NAME}.pt")
    if a.name != LAST_NAME and not os.path.exists(last):
        os.link(os.path.join(a.out, f"{a.name}.pt"), last)
    # a wrong offset order loads cleanly and only shows up as scrambled
    # predictions: record the choice next to the checkpoint
    meta = {"source": a.torch_ckpt, "arch": arch,
            "offset_order": offset_order}
    if scores is not None:
        meta["auto_scores"] = scores  # the decision's evidence
    with open(os.path.join(a.out, "convert_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    n = sum(1 for _ in model.parameters())
    print(f"converted {a.torch_ckpt} -> {a.out}/{a.name}.pt "
          f"({n} param tensors, offset order {offset_order})")
    return a.out


if __name__ == "__main__":
    main()
