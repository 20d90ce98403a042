"""The wall time (ms) of the teacher phase of one scene: the crop-mask
prompts and the vision tower over every present (view, object) pair
(``extract_obj_prior``). The scene runs after the traced sub-window with
``process_scene(sync_timings=True)``, which synchronises the card at
each phase's end (``t_teacher``)."""


def read(run):
    phases = run.work.get("phases")
    if phases is None:
        return None
    return 1e3 * phases["t_teacher"]
