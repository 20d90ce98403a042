"""The served calls' share of the card's peak in the student's dtype
(float32 at 3xTF32's 165 TFLOP/s): the student forward's convs over
every scene of every call of the traced run's measured window (counted
on the benchmark's own voxelization; the text features come from the
set-up's cache and add no work), over the window's wall time. In
percent."""

from benchmark.peaks import least_seconds


def read(run):
    if "window_flops" not in run.work:
        return None
    least, _ = least_seconds(run.work["window_flops"], 0, run.work["dtype"])
    return 100.0 * least / run.work["window_s"]
