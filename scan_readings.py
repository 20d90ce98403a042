"""Readings behind two checks of the scanned trainer's slice, on one card.

1. The update gap of ``tests/test_torch_kernels_cuda.py::
   test_scanned_train_graph_matches_eager_steps`` at that test's size
   (MinkUNet14A, 32-d, six staged scenes, three warm eager steps, then six
   steps as a CUDA graph and as eager steps): the sound runs and a planted
   fault, a graph whose optimizer step count does not advance, for each
   of the test's (remat, dropout) cases. The test's ``SCAN_GAP`` lies
   between the two.
2. ``torch.profiler`` kernel counts of fresh sessions of known eager calls
   around a CUDA graph: before any graph, while a graph that was replayed
   only outside a profiler is alive, after a session that profiled its
   replays (graph still alive), and after the graph is freed. Each session
   runs 101 calls of an in-place scale (one kernel a call, the card
   synchronised after each; each kernel placed in its call by the calls'
   host start times) or 101 back-to-back calls of K6 (``layer_norm``);
   then the same sessions, and sessions of one scale call, after
   ``chip_smoke.py``'s scan phases (the scanned trainer against the eager
   loop, the trainer CLI with ``scan_epochs``) have run in this process.
   ``chip_smoke.profiler_count_check`` rests on what this shows.

Run on the card from the repo's root: ``python scan_readings.py``.
"""

import bisect
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def compress(ix):
    """[0, 1, 2, 5] -> "0-2,5"."""
    out, i = [], 0
    while i < len(ix):
        j = i
        while j + 1 < len(ix) and ix[j + 1] == ix[j] + 1:
            j += 1
        out.append(f"{ix[i]}-{ix[j]}" if j > i else str(ix[i]))
        i = j + 1
    return ",".join(out) or "none"


def scale_session(tag, n=101):
    """n calls of an in-place scale under a fresh profiler session: the
    kernels seen and the calls without one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            x.mul_(1.0000001)
            torch.cuda.synchronize()
    events = prof.events()
    calls = sorted(e.time_range.start for e in events
                   if e.name == "aten::mul_"
                   and e.device_type == DeviceType.CPU)
    kernels = [e.time_range.start for e in events
               if e.device_type == DeviceType.CUDA]
    seen = {bisect.bisect_right(calls, k) - 1 for k in kernels}
    missing = [i for i in range(len(calls)) if i not in seen]
    print(f"profiler {tag}: scale x{n}: {len(calls)} calls, {len(kernels)} "
          f"kernels, calls without one {compress(missing)}", flush=True)


def k6_session(tag, n=101):
    """n back-to-back K6 calls at (308, 768) bf16 under a fresh session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dropclip_tpu_torch.ops.layernorm import layer_norm

    x = torch.randn(308, 768, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda")
    b = torch.zeros(768, device="cuda")
    layer_norm(x, w, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            layer_norm(x, w, b)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f"profiler {tag}: K6 x{n}: {len(kernels)} kernels", flush=True)


def profiler_readings():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scale_session("fresh")
    k6_session("fresh")
    x = torch.randn(1 << 20, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2 + 1
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2 + 1
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    scale_session("graph replayed unprofiled, alive")
    k6_session("graph replayed unprofiled, alive")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            graph.replay()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    print(f"profiler: 10 graph replays profiled: {n} kernels (2 a replay)",
          flush=True)
    for i in range(3):
        scale_session(f"graph replayed profiled, alive, session {i + 1}")
        k6_session(f"graph replayed profiled, alive, session {i + 1}")
    del graph, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for i in range(2):
        scale_session(f"graph freed, session {i + 1}")
        k6_session(f"graph freed, session {i + 1}")


def one_call_sessions(tag, n=6):
    """n sessions of one scale call each: the kernels each one saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(n):
        x = torch.randn(1 << 20, device="cuda")
        x.mul_(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x.mul_(1.0000001)
            torch.cuda.synchronize()
        seen.append(sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA))
    print(f"profiler {tag}: one-call sessions saw {seen} kernels",
          flush=True)


def after_scan_phases():
    """The sessions again after chip_smoke's scan phases in this
    process (their own checks' failures are printed, not raised)."""
    import traceback

    import chip_smoke

    report = {}
    for phase in (chip_smoke.scan_train_phase, chip_smoke.scan_cli_phase):
        try:
            phase(report)
        except Exception:
            traceback.print_exc()
    for i in range(3):
        scale_session(f"after the scan phases, session {i + 1}", n=121)
    k6_session("after the scan phases")
    one_call_sessions("after the scan phases")


def test_size_readings():
    import test_torch_kernels_cuda as cases
    from dropclip_tpu_torch.distill.train_state import AmsgradChain

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = ((False, 0.0), (True, 0.0), (False, 0.2))
    for remat, dropout in grid:
        got, want, gap, _ = cases._scanned_against_eager(cuda, remat,
                                                         dropout)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"test size, remat {remat}, dropout {dropout}: sound gap "
              f"{gap}, losses max rel {rel}", flush=True)
    update = AmsgradChain.update

    def frozen(chain, model, opt_state, count=None):
        norm = update(chain, model, opt_state, count)
        if count is not None:
            count.sub_(1)
        return norm

    AmsgradChain.update = frozen
    try:
        for remat, dropout in grid:
            gap = cases._scanned_against_eager(cuda, remat, dropout)[2]
            print(f"test size, remat {remat}, dropout {dropout}: count "
                  f"frozen gap {gap} (limit {cases.SCAN_GAP})", flush=True)
    finally:
        AmsgradChain.update = update


def main():
    if not torch.cuda.is_available():
        sys.exit("scan_readings.py needs an NVIDIA card")
    profiler_readings()
    one_call_sessions("before the scan phases")
    test_size_readings()
    after_scan_phases()


if __name__ == "__main__":
    main()
