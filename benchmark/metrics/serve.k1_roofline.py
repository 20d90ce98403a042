"""K1's share of its roofline in the served student forwards: the least
time of its launches' work (occupied pairs of each k3 conv, counted on
the benchmark's own voxelization of each scene; float32 at 3xTF32's 165
TFLOP/s, or its bytes at 3.35 TB/s), over K1's device time in the
traced calls. In percent."""

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
