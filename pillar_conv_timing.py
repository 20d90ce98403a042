#!/usr/bin/env python3
"""Per-forward times of the pillar conv (K2) on one CUDA card.

    python3 pillar_conv_timing.py [--tree DIR] [--reps N] [--n-occ N]

Times ``kernels/pillar_conv3.pillar_conv3`` from the checkout at ``--tree``
(default: this one), so that two versions of the kernel can be compared
on one card in one call, in turns (parent, change, change, parent). The
kernel is built from that checkout's sources into its own
``build/kernels/``. The inputs are ``chip_smoke.py``'s: the 16 k3 convs
of one pillar forward (configs/DistilBlender.yaml with sparse_backend
pillars, full width) on volumetric scene 0 at the static shapes fitted
over all 8 scenes, seeded features zero on empty slots, random scale,
bias and relu, in float32 and in bf16. ``--n-occ`` draws the scenes with
another voxel count (``make_volumetric_clouds``; 6000 gives about 5100
voxels after the pipeline's voxelization). Each call is first held against
the plain version to K2's limits (``chip_smoke.k2_limits``); each time is
the mean of ``--reps`` back-to-back calls between CUDA events, after two
warm-up calls (``chip_smoke.cuda_ms``). A checkout whose K2 takes a row
schedule gets each level's once, as the student shares it, and its cost
is timed apart and added to the per-forward sums. Prints nvcc's ptxas
lines for K2, one line per conv, the per-forward sums, the card line
(``nvidia-smi`` name and power limit) and, last, one JSON object.
"""

import argparse
import json
import os
import re
import sys
import time

import torch

from chip_smoke import (BATCH, ROOT, SEED, card_line, check, cuda_ms,
                        k2_call, k2_cases, k2_inputs, k2_limits,
                        k2_schedule_ms, make_volumetric_clouds,
                        pillar_pipeline, ptxas_entries)

DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose dropclip_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--n-occ", type=int, default=6000,
                    help="voxels drawn per volumetric scene")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pillar_conv_timing: no CUDA device visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from dropclip_tpu_torch.core.config import load_cfg
    from dropclip_tpu_torch.kernels.pillar_conv3 import (LIB, pillar_conv3,
                                                         pillar_conv3_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t = time.time()
    LIB.build()
    print(f"built {LIB.source} in {time.time() - t:.2f} s", flush=True)
    for fn, lines in ptxas_entries(LIB.build_log).items():
        short = re.sub(r"^_ZN.*_cu_[0-9a-f]{8}\d*", "", fn)[:60]
        print(f"  ptxas {short}: {'; '.join(lines)}", flush=True)

    cfg = load_cfg(os.path.join(ROOT, "configs", "DistilBlender.yaml"))
    clouds, rgbs = make_volumetric_clouds(BATCH, args.n_occ)
    _, ppipe = pillar_pipeline(cfg, clouds, rgbs, None)
    cases = k2_cases(ppipe, clouds, rgbs)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, total = [], {tag: 0.0 for tag, _ in DTYPES}
    for i, lvl, c, cout, lv, pairs, sched in cases:
        relu = i % 2 == 0
        row = dict(shape=i, level=lvl, p=lv.occ.shape[0], z=lv.occ.shape[1],
                   c=c, cout=cout, occupied_pairs=pairs)
        for tag, dtype in DTYPES:
            conv_args = k2_inputs(lv, c, cout, dtype, gen)
            ok, err, scale = k2_limits(
                k2_call(pillar_conv3, conv_args, relu, sched),
                pillar_conv3_plain(*conv_args, relu=relu), dtype)
            check(ok, f"K2 {tag} shape {i} (L{lvl} {c}->{cout}): max err "
                  f"{err} vs max|ref| {scale}")
            row[tag] = cuda_ms(
                lambda: k2_call(pillar_conv3, conv_args, relu, sched),
                args.reps)
            row[f"{tag}_rel_err"] = err / scale
            total[tag] += row[tag]
        rows.append(row)
        print(f"L{lvl} {c:4d}->{cout:4d}: f32 {row['f32']:.4f} ms (rel err "
              f"{row['f32_rel_err']:.2e}), bf16 {row['bf16']:.4f} ms (rel "
              f"err {row['bf16_rel_err']:.2e})", flush=True)
    sched_ms = k2_schedule_ms(cases)
    print(f"per forward (16 convs, with {sched_ms:.4f} ms of row "
          f"schedules): f32 {total['f32'] + sched_ms:.4f} ms, bf16 "
          f"{total['bf16'] + sched_ms:.4f} ms", flush=True)
    print(card)
    print(json.dumps({"tree": tree, "card": card, "calls_ms": total,
                      "schedule_ms": sched_ms, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
