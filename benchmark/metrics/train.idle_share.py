"""The card's idle share over the traced window: one less the union of
its kernel, copy and fill intervals over the window's wall time. In
percent."""


def read(run):
    if run.probe is None:
        return None
    return 100.0 * (1.0 - run.probe.busy_s() / run.probe.window_s)
