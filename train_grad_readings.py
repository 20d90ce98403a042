#!/usr/bin/env python3
"""Readings of ``chip_smoke.py``'s train-gradient checks on one CUDA card,
over several data seeds.

    python3 train_grad_readings.py [--seeds 0 1]

For each seed, ``chip_smoke.train_setup(seed)`` (MinkUNet14D at full
width, batch 8 of tabletop scenes, configs/DistilBlender.yaml's recipe)
and then the step-1 float32 phase (``train_grads_phase``) and the bf16
phase (``train_bf16_phase``), with TF32 off. A failed check is printed
and counted, not raised, so that every reading of every seed is shown:
these are the readings the limits of those phases are set between (the
sound ones and the planted faults'). Prints the card line (``nvidia-smi``
name and power limit), the phases' lines, and, last, one JSON object with
the failed checks; writes every reading to
chiprun_out/train_grad_readings.json.
"""

import argparse
import json
import os
import time

import torch

import chip_smoke


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_grad_readings: no CUDA device visible")
    failed = []

    def check(cond, msg):
        if not cond:
            print(f"check failed: {msg}", flush=True)
            failed.append(msg)

    chip_smoke.check = check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    out = {}
    for seed in args.seeds:
        t = time.time()
        report = {}
        cfg, batch, host = chip_smoke.train_setup(seed)
        ref32 = chip_smoke.train_grads_phase(cfg, batch, host, report)
        chip_smoke.train_bf16_phase(cfg, batch, host, ref32, report)
        print(f"seed {seed}: {time.time() - t:.1f} s", flush=True)
        out[seed] = report
        del ref32, host, batch
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(chip_smoke.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(chip_smoke.ROOT, "chiprun_out",
                           "train_grad_readings.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"seeds": args.seeds, "failed": failed}))


if __name__ == "__main__":
    main()
