"""The mean wall (ms) of one ViT-H/14 forward over a 96-crop chunk: the
program's ``dropclip.teacher.tower`` spans (one around each obj-prior
ViT forward of ``extract_obj_prior``) in the traced scenes, on the host's
clock: the enqueue of the forward, and the waits for the card that fall
inside it. None where the program has no such span."""

from benchmark import spans


def read(run):
    if run.probe is None:
        return None
    found = spans.named(run.probe, "teacher.tower")
    if not found:
        return None
    return sum(e - s for s, e in found) / len(found) / 1e3
