"""Native (C) host components, loaded with ctypes, each behind a numpy
fallback.

Port of ``dropclip_tpu/native``: ``rle.c`` (the COCO run-length mask
codec of raw MV-TOD ingest) is built with the system C compiler (``$CC``,
else ``cc``) at first use into ``build/native/`` of the checkout
(gitignored), never beside its source, under a name hashed from the source
and the flags, so an edited source rebuilds. Nothing is built when the
module is imported. Without a C compiler, or when the build fails,
``load`` returns None and ``data.rle`` runs its numpy codec; ``route()``
says which of the two ran. This is host code, not a kernel of the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "rle.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """Where this source and these flags build to."""
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"librle_{digest}.so"


def _build(so: Path) -> bool:
    """Compile into a temporary name and rename it into place, so workers
    that build at once never load a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cc = os.environ.get("CC", "cc")
    try:
        subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[dropclip_tpu_torch.native] build with {cc!r} failed ({e}); "
              "using the numpy codec", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


@functools.cache
def load() -> Optional[ctypes.CDLL]:
    """The RLE library, built on first use; None where it cannot be built
    or opened (the callers then use their numpy codec)."""
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_long, ctypes.c_long]
    lib.rle_encode.restype = ctypes.c_long
    lib.rle_encode.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                               ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
    return lib


def route() -> str:
    """Which RLE codec this process runs: ``"native <library path>"`` or
    ``"numpy"``."""
    return f"native {library_path()}" if load() is not None else "numpy"
