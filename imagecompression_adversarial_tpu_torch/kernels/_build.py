"""Build the port's CUDA sources with ``nvcc`` into a C-ABI shared library
and load it with ``ctypes``.

The library is built on first use into ``_build/`` beside the package,
under a name keyed by a hash of the sources and the flags, so an edited
source or flag builds anew and an unchanged one is reused.  A file lock
serialises concurrent builds.  Plain ``nvcc`` on a source with a C
interface takes seconds; nothing here includes PyTorch's headers.  What
nvcc prints, ``ptxas``'s registers, shared memory and spills of each kernel
included (``-Xptxas -v``), is kept beside the library (``build_log``).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (CSRC_DIR / "gdn.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "GDN kernel is built only where the CUDA toolkit is installed"
    )


def nvcc_command(nvcc: str, sources: Sequence[Path], output: Path) -> List[str]:
    """The compile command for ``sources`` into the shared library ``output``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(output), *map(str, sources)]


def library_path(sources: Sequence[Path] = SOURCES) -> Path:
    """``_build/libicat_kernels-<hash>.so``, keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libicat_kernels-{h.hexdigest()[:16]}.so"


def build_log(sources: Sequence[Path] = SOURCES) -> str:
    """nvcc's output from the build of the library for ``sources``."""
    return library_path(sources).with_suffix(".log").read_text()


def build(sources: Sequence[Path] = SOURCES) -> Path:
    """Compile ``sources`` unless the keyed library already exists; return
    its path."""
    out = library_path(sources)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.is_file():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                nvcc_command(nvcc, sources, tmp), capture_output=True, text=True
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.icat_gdn_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.icat_gdn_fwd.restype = i32
    lib.icat_gdn_layout.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.icat_gdn_layout.restype = i32
    return lib
