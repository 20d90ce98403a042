"""The wall time (ms) of the aggregation phase of one scene: every view
unprojected and the labelled cloud voxel-downsampled
(``aggregate_views``). The scene runs after the traced sub-window with
``process_scene(sync_timings=True)``, which synchronises the card at
each phase's end (``t_aggregate``)."""


def read(run):
    phases = run.work.get("phases")
    if phases is None:
        return None
    return 1e3 * phases["t_aggregate"]
