#!/usr/bin/env python3
"""Per-forward times of the brick conv (K1) on one CUDA card.

    python3 brick_conv_timing.py [--tree DIR] [--reps N]

Times ``kernels/brick_conv3.brick_conv3`` from the checkout at ``--tree``
(default: this one), so that two versions of the kernel can be compared
on one card in one call, in turns (parent, change, change, parent). The
kernel is built from that checkout's sources into its own
``build/kernels/``. The inputs are ``chip_smoke.py``'s: the 16 k3 convs
of one MinkUNet14D forward (configs/DistilBlender.yaml, full width) on
the folded topology of 8 tabletop scenes, seeded features zero on empty
voxels, in float32 and in bf16. Each call is first held against the plain
version to K1's limits (``chip_smoke.k1_close``); each time is the mean of
``--reps`` back-to-back calls between CUDA events, after two warm-up calls
(``chip_smoke.cuda_ms``). A checkout whose K1 takes a row schedule gets
each level's once, as the student shares it, and its cost is timed apart
and added to the per-forward sums. Prints nvcc's ptxas lines for K1, one
line per conv, the per-forward sums, the card line (``nvidia-smi`` name
and power limit) and, last, one JSON object.
"""

import argparse
import json
import os
import re
import sys
import time

import torch

from chip_smoke import (BATCH, ROOT, SEED, brick_pipeline, card_line, check,
                        cuda_ms, k1_call, k1_cases, k1_close, k1_inputs,
                        k1_schedule_ms, make_clouds, ptxas_entries)

DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose dropclip_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("brick_conv_timing: no CUDA device visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from dropclip_tpu_torch.core.config import load_cfg
    from dropclip_tpu_torch.kernels.brick_conv3 import (LIB, brick_conv3,
                                                        brick_conv3_plain)

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
    clouds, rgbs = make_clouds(BATCH)
    pipe = brick_pipeline(cfg, clouds, rgbs, None)
    cases = k1_cases(pipe, clouds, rgbs)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, total = [], {tag: 0.0 for tag, _ in DTYPES}
    for i, lvl, c, cout, lv, pairs, sched in cases:
        row = dict(shape=i, level=lvl, bm=lv.occ.shape[0], c=c, cout=cout,
                   occupied_pairs=pairs)
        for tag, dtype in DTYPES:
            x, w = k1_inputs(lv, c, cout, dtype, gen)
            ok, err, scale = k1_close(k1_call(brick_conv3, x, lv, w, sched),
                                      brick_conv3_plain(x, lv.nbr, w, lv.occ),
                                      dtype)
            check(ok, f"K1 {tag} shape {i} (L{lvl} {c}->{cout}): max err "
                  f"{err} vs max|ref| {scale}")
            row[tag] = cuda_ms(lambda: k1_call(brick_conv3, x, lv, w, sched),
                               args.reps)
            row[f"{tag}_rel_err"] = err / scale
            total[tag] += row[tag]
        rows.append(row)
        print(f"L{lvl} {c:4d}->{cout:4d}: f32 {row['f32']:.4f} ms (rel err "
              f"{row['f32_rel_err']:.2e}), bf16 {row['bf16']:.4f} ms (rel "
              f"err {row['bf16_rel_err']:.2e})", flush=True)
    sched_ms = k1_schedule_ms(cases)
    print(f"per forward (16 convs, batch {BATCH}, with {sched_ms:.4f} ms of "
          f"row schedules): f32 {total['f32'] + sched_ms:.4f} ms, bf16 "
          f"{total['bf16'] + sched_ms:.4f} ms", flush=True)
    print(card)
    print(json.dumps({"tree": tree, "card": card, "calls_ms": total,
                      "schedule_ms": sched_ms, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
