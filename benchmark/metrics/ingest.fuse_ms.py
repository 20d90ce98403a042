"""The wall time (ms) of the fusion phase of one scene: the text queries'
encode and the object-prior fusion with its visibility
(``fuse_obj_prior``). The scene runs after the traced sub-window with
``process_scene(sync_timings=True)``, which synchronises the card at
each phase's end (``t_fuse``)."""


def read(run):
    phases = run.work.get("phases")
    if phases is None:
        return None
    return 1e3 * phases["t_fuse"]
