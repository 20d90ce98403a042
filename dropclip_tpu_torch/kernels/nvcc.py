"""Build and load the port's CUDA C++ kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` (gitignored) at first
use, named by a hash of the flags, the source and the headers it
includes, so that an edited source or header rebuilds, and is loaded
with ``ctypes``. Nothing is built when a module is imported: the CPU
tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def find_nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source: ``build()`` compiles it if this
    source and these flags have no library yet, ``load()`` opens it once
    and lets ``bind`` set the ctypes signatures. ``build_log`` keeps
    nvcc's output (ptxas registers, shared memory and spills), which is
    also kept beside the library for a later process that finds it
    built."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 defines: Tuple[str, ...] = ()):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self._lib = None
        self.flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        self.build_log = ""

    def variant(self, *defines: str) -> "CudaLibrary":
        """The same source built apart with preprocessor ``defines``
        (``"NAME=value"``), e.g. a measurement probe; not registered
        with ``library``."""
        return CudaLibrary(self.name, self._bind, defines)

    def sources(self) -> Tuple[Path, ...]:
        """The source and every file of ``csrc/`` it includes with quotes,
        directly or through another include."""
        found, todo = [], [self.source]
        while todo:
            path = todo.pop()
            if path in found:
                continue
            found.append(path)
            todo += [path.parent / m.group(1) for m in
                     _INCLUDE.finditer(path.read_text())]
        return tuple(found)

    def library_path(self) -> Path:
        """Named by a hash of the flags and of every source file, so that
        an edit to a shared header rebuilds each library that includes
        it."""
        h = hashlib.sha256(" ".join(self.flags).encode())
        for path in self.sources():
            h.update(path.name.encode() + b"\0" + path.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile if needed; returns the library's path. Safe against
        concurrent builders (atomic rename)."""
        lib = self.library_path()
        log = lib.with_suffix(".log")
        if lib.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *self.flags, "-o", tmp, str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"({proc.returncode}):\n{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, lib)
        return lib

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.dropclip_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dropclip_cuda_error_string.restype = ctypes.c_char_p
            self._bind(lib)
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err:
            msg = self.load().dropclip_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} launch failed: {err} ({msg})")


LIBRARIES: Dict[str, CudaLibrary] = {}


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> CudaLibrary:
    """The process-wide handle of ``csrc/<name>.cu``."""
    if name not in LIBRARIES:
        LIBRARIES[name] = CudaLibrary(name, bind)
    return LIBRARIES[name]
