"""K1's share of its roofline in the train step: the least time of its
forward and input-gradient launches' work (occupied pairs of each k3
conv, counted from the benchmark's coordinates; float32 at 3xTF32's 165
TFLOP/s, or its bytes at 3.35 TB/s), over K1's device time in the traced
window. In percent."""

from benchmark.peaks import least_seconds


def read(run):
    if run.probe is None or "k1_flops" not in run.work:
        return None
    k1_s = run.probe.kernel_s(lambda n: "brick_conv3" in n)
    if k1_s <= 0:
        return None
    least, _ = least_seconds(run.work["k1_flops"], run.work["k1_bytes"],
                             run.work["dtype"])
    return 100.0 * least / k1_s
