"""Fusion-quality upper-bound evaluation: the CLI alias.

Port of ``dropclip_tpu/tools/validate_upper_bound.py`` (reference
tools/validate_upper_bound.py:164-313): the grounding eval scoring the
fused teacher features themselves as if they were the student's output
(``out = targets``, :191-192), the ceiling a perfect student could reach.
The same as ``validate_blender --opts eval_upper_bound True``.
"""

from __future__ import annotations

import sys

from .validate_blender import main as validate_main


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--opts" not in argv:
        argv.append("--opts")
    i = argv.index("--opts")
    return validate_main(argv[:i + 1] + ["eval_upper_bound", "True"]
                         + argv[i + 1:])


if __name__ == "__main__":
    main()
