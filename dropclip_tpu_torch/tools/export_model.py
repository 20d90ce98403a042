"""Export the grounding program as one ``torch.export`` artifact (``.pt2``).

Port of ``dropclip_tpu/tools/export_model.py``: the whole device program,
brick topology build -> sparse UNet forward -> paired-softmax grounding
against precomputed text embeddings, exported once with the student's
weights inside, to a single file that ``dropclip_tpu_torch.serve.
load_exported`` runs without the model code, the checkpoint or the
config. Text encoding stays on the host by design: the serve contract
takes (Q, C) positive and (Q, Nneg, C) negative text embeddings, which a
text front end (the CLIP text tower, or a cache of prompts) produces on
its own.

The program is exported for one device (``--device``, the card by
default): on the card every k3 conv is K1, recorded as the registered op
``dropclip::brick_conv3`` (``kernels/brick_conv3.py``), which the loaded
artifact launches; on the CPU the same op runs the plain version. The
brick grid is fixed at export, at the JAX artifact's ``grid_bits`` 5
(+-64 voxels): a grid sized from the data is a host read that a trace
cannot hold, and ``dropped`` reports what lies past it.

Usage::

    python -m dropclip_tpu_torch.tools.export_model \\
        --config configs/DistilBlender.yaml --ckpt-dir exp/run1 \\
        --out student_serve.pt2 --nq 8 --nneg 8 --check

    # smoke (random weights, tiny arch) on the CPU:
    python -m dropclip_tpu_torch.tools.export_model --config ... \\
        --random-init --out /tmp/m.pt2 --check --device cpu \\
        --opts arch_3d tiny feat_dim 16 voxel_capacity 256
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

# the JAX artifact's fixed brick grid (+-64 voxels)
EXPORT_GRID_BITS = 5


class ServeProgram(nn.Module):
    """The device program exported for serving (batch 1, static shapes),
    the JAX ``build_serve_fn``'s counterpart around ``model`` (the
    student, in eval mode on its device):

    (coords (1, cap, 3) i32, mask (1, cap) bool, in_feats (1, cap, F)
    f32, qpos (nq, C) f32, qneg (nq, nneg, C) f32) ->
    (masks (nq, cap) bool, sims (nq, cap) f32, dropped () int64)

    Voxelization stays on the host (``data.voxelize_np``, as in
    ``GroundingPipeline.featurize``); ``dropped`` counts the voxels past
    the brick grid or a brick capacity, so the serving layer can alert
    instead of silently losing geometry."""

    def __init__(self, cfg, model: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.model = model.eval()
        self.method = str(cfg.sim_method or "paired")
        self.threshold = float(cfg.sim_norm_thresh or 0.75)

    def forward(self, coords, mask, in_feats, qpos, qneg):
        from ..distill.engine import build_topology, topology_dropped
        from ..similarity import predict_queries

        topo = build_topology(self.cfg, coords, mask, EXPORT_GRID_BITS)
        out = self.model(topo, in_feats)
        out = out[0] if isinstance(out, tuple) else out
        masks, sims = predict_queries(out[0], qpos, qneg, mask=mask[0],
                                      method=self.method,
                                      threshold=self.threshold)
        return masks, sims, topology_dropped(topo)


def example_inputs(cfg, nq: int, nneg: int, seed: int = 0, device=None):
    """Inputs at the artifact's shapes: the first half of the capacity
    occupied by distinct random voxels of a cube with twice as many
    cells, centred on 0 (the JAX function draws them with repeats in
    [-8, 8), and two inputs on one voxel make the brick scatter's result
    depend on the card's write order), unit text embeddings, on
    ``device`` (the card unless the caller asks for the CPU)."""
    from ..core.device import resolve_device

    device = resolve_device(device)
    cap = int(cfg.voxel_capacity or 8192)
    fdim = 6 if cfg.use_color else 3
    c = int(cfg.feat_dim or 768)
    rng = np.random.RandomState(seed)
    n = max(cap // 2, 1)
    side = int(np.ceil((2 * n) ** (1 / 3)))
    cells = rng.choice(side ** 3, size=n, replace=False)
    coords = np.zeros((1, cap, 3), np.int32)
    coords[0, :n] = np.stack(np.unravel_index(cells, (side,) * 3),
                             -1) - side // 2
    mask = np.arange(cap)[None] < n
    feats = rng.randn(1, cap, fdim).astype(np.float32)

    def unit(shape):
        e = rng.randn(*shape).astype(np.float32)
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    return tuple(torch.as_tensor(a, device=device) for a in (
        coords, mask, feats, unit((nq, c)), unit((nq, nneg, c))))


@torch.no_grad()
def export_serve(cfg, model: nn.Module, out_path: str, nq: int, nneg: int,
                 device) -> "torch.export.ExportedProgram":
    """Trace the serve program on ``device`` (non-strict ``torch.export``)
    and save it to ``out_path``; returns the ExportedProgram. One eager
    call runs first, which builds and loads K1 on the card and makes its
    cached tables, so the trace records them as constants."""
    program = ServeProgram(cfg, model.to(device))
    args = example_inputs(cfg, nq, nneg, device=device)
    program(*args)
    exported = torch.export.export(program, args, strict=False)
    torch.export.save(exported, out_path)
    return exported


def load_student(args, cfg, device) -> nn.Module:
    """The student with random weights (``--random-init``, seeded) or the
    port trainer's checkpoint ``<ckpt_dir>/<ckpt_name>.pt``."""
    from ..distill.engine import build_student_for

    model = build_student_for(
        cfg, generator=torch.Generator().manual_seed(args.seed))
    if not args.random_init:
        from ..core.checkpoint import load_model

        load_model(model, args.ckpt_dir, args.ckpt_name, map_location="cpu")
    return model.to(device).eval()


def main(argv=None) -> int:
    from ..core.config import load_cfg, merge_cfg_from_list
    from ..core.device import resolve_device

    ap = argparse.ArgumentParser(
        description="export the grounding program with torch.export")
    ap.add_argument("--config", required=True)
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=None,
                    help="config overrides, 'key value ...' (the CLIs' "
                         "--opts; must repeat the shape options of "
                         "training)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-name", default="best_sim_loss_model")
    ap.add_argument("--random-init", action="store_true",
                    help="random weights from --seed (smoke and tests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--nq", type=int, default=8,
                    help="query bucket the artifact serves")
    ap.add_argument("--nneg", type=int, default=8,
                    help="negatives per query")
    ap.add_argument("--device", default=None,
                    help="torch device the program is exported for "
                         "(default: the CUDA card)")
    ap.add_argument("--check", action="store_true",
                    help="load the artifact and compare it with the live "
                         "program on other inputs")
    args = ap.parse_args(argv)
    if not (args.random_init or args.ckpt_dir):
        ap.error("need --ckpt-dir (or --random-init for a smoke run)")

    cfg = load_cfg(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, list(args.opts))
    device = resolve_device(args.device)
    model = load_student(args, cfg, device)
    exported = export_serve(cfg, model, args.out, args.nq, args.nneg,
                            device)
    k1_nodes = sum(1 for n in exported.graph.nodes
                   if "dropclip.brick_conv3" in str(n.target))
    print(f"exported {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, device {device}, "
          f"{len(exported.graph.nodes)} nodes, {k1_nodes} K1 ops)")
    if args.check:
        from ..serve import load_exported

        run = load_exported(args.out)
        inputs = example_inputs(cfg, args.nq, args.nneg, seed=1,
                                device=device)
        with torch.no_grad():
            got = run(*inputs)
            want = ServeProgram(cfg, model)(*inputs)
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      want[0].cpu().numpy())
        np.testing.assert_allclose(got[1].cpu().numpy(),
                                   want[1].cpu().numpy(), rtol=2e-5,
                                   atol=2e-5)
        assert int(got[2]) == int(want[2])
        print("# roundtrip check ok: the loaded artifact matches the live "
              "program")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
