"""K3's share of its roofline in the traced scenes: the least time of
its launches' work (``4 * rows * tokens**2 * width`` a launch at bf16's
989 TFLOP/s, or its q, k, v and output at 3.35 TB/s, whichever is
longer; 96 crops a launch, as the program chunks them, and as many
launches as the counting predicts, which the driver holds the program's
launch counter to), over the attention kernel's device time. In
percent."""

from benchmark.peaks import least_seconds


def read(run):
    if run.probe is None or "attention_flops" not in run.work:
        return None
    k3_s = run.probe.kernel_s(lambda n: "attention_kernel" in n)
    if k3_s <= 0:
        return None
    least, _ = least_seconds(run.work["attention_flops"],
                             run.work["attention_bytes"], "bfloat16")
    return 100.0 * least / k3_s
