"""Build the port's native sources into C-ABI shared libraries and load
them with ``ctypes``.

Seven libraries, each built on first use into ``_build/`` beside the package
under a name keyed by a hash of its sources and flags, so an edited source
or flag builds anew and an unchanged one is reused.  One file lock
serialises concurrent builds of all of them.

* ``libicat_kernels-<hash>.so``: the CUDA kernels (the GDN forward and
  backward), by ``nvcc``.  Plain ``nvcc`` on a source with a C interface
  takes seconds; nothing here includes PyTorch's headers.  What nvcc
  prints, ``ptxas``'s registers, shared memory and spills of each kernel
  included (``-Xptxas -v``), is kept beside the library (``build_log``).
* ``libicat_rans-<hash>.so``: the host rANS coder (``csrc/rans.cc``), by
  ``g++``, so that the real coder runs where there is no CUDA toolkit;
* ``libicat_jpeg-<hash>.so``: the host JPEG decoder (``csrc/jpeg.cc``),
  by ``g++``, which every image reader of the port takes for JPEG files;
* ``libicat_png-<hash>.so``: the host PNG decoder (``csrc/png.cc``), by
  ``g++``, which every image reader of the port takes for PNG files;
* ``libicat_webp-<hash>.so``: the host WebP decoder (``csrc/webp.cc``), by
  ``g++``, which every image reader of the port takes for WebP files;
* ``libicat_tiff-<hash>.so`` and ``libicat_gif-<hash>.so``: the host TIFF
  and GIF decoders (``csrc/tiff.cc``, ``csrc/gif.cc``), by ``g++``, which
  every image reader of the port takes for TIFF and GIF files.
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
from typing import Callable, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (CSRC_DIR / "gdn.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
RANS_SOURCE = CSRC_DIR / "rans.cc"
JPEG_SOURCE = CSRC_DIR / "jpeg.cc"
PNG_SOURCE = CSRC_DIR / "png.cc"
WEBP_SOURCE = CSRC_DIR / "webp.cc"
TIFF_SOURCE = CSRC_DIR / "tiff.cc"
GIF_SOURCE = CSRC_DIR / "gif.cc"
JPEG2000_SOURCE = CSRC_DIR / "jpeg2000.cc"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# the 9/7 synthesis and the ICT round as OpenJPEG's float code does only
# where no multiply-add is fused
JPEG2000_FLAGS = (*GXX_FLAGS, "-ffp-contract=off")


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


def _keyed_path(stem: str, flags: Sequence[str], sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def library_path(sources: Sequence[Path] = SOURCES) -> Path:
    """``_build/libicat_kernels-<hash>.so``, keyed by sources and flags."""
    return _keyed_path("libicat_kernels", NVCC_FLAGS, sources)


def rans_library_path() -> Path:
    """``_build/libicat_rans-<hash>.so``, keyed by source and flags."""
    return _keyed_path("libicat_rans", GXX_FLAGS, (RANS_SOURCE,))


def jpeg_library_path() -> Path:
    """``_build/libicat_jpeg-<hash>.so``, keyed by source and flags."""
    return _keyed_path("libicat_jpeg", GXX_FLAGS, (JPEG_SOURCE,))


def png_library_path() -> Path:
    """``_build/libicat_png-<hash>.so``, keyed by source and flags."""
    return _keyed_path("libicat_png", GXX_FLAGS, (PNG_SOURCE,))


def webp_library_path() -> Path:
    """``_build/libicat_webp-<hash>.so``, keyed by source and flags."""
    return _keyed_path("libicat_webp", GXX_FLAGS, (WEBP_SOURCE,))


def tiff_library_path() -> Path:
    """``_build/libicat_tiff-<hash>.so``, keyed by source and flags."""
    return _keyed_path("libicat_tiff", GXX_FLAGS, (TIFF_SOURCE,))


def gif_library_path() -> Path:
    """``_build/libicat_gif-<hash>.so``, keyed by source and flags."""
    return _keyed_path("libicat_gif", GXX_FLAGS, (GIF_SOURCE,))


def jpeg2000_library_path() -> Path:
    """``_build/libicat_jpeg2000-<hash>.so``, keyed by source and flags."""
    return _keyed_path("libicat_jpeg2000", JPEG2000_FLAGS, (JPEG2000_SOURCE,))


def build_log(sources: Sequence[Path] = SOURCES) -> str:
    """nvcc's output from the build of the library for ``sources``."""
    return library_path(sources).with_suffix(".log").read_text()


def _compile(out: Path, command: Callable[[Path], List[str]]) -> Path:
    """Run ``command(tmp)`` under the build lock unless ``out`` exists, keep
    its output beside the library as ``.log`` and move ``tmp`` to ``out``."""
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.is_file():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = command(tmp)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{Path(cmd[0]).name} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
    return out


def build(sources: Sequence[Path] = SOURCES) -> Path:
    """Compile ``sources`` with nvcc unless the keyed library already
    exists; return its path."""
    out = library_path(sources)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    return _compile(out, lambda tmp: nvcc_command(nvcc, sources, tmp))


def _build_host(out: Path, source: Path, what: str, flags: Sequence[str] = GXX_FLAGS) -> Path:
    """Compile the host C++ ``source`` with g++ and ``flags`` into ``out``
    unless it already exists; return ``out``."""
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; {what} is built with it")
    return _compile(out, lambda tmp: [gxx, *flags, "-o", str(tmp), str(source)])


def build_rans() -> Path:
    """Compile ``csrc/rans.cc`` with g++ unless the keyed library already
    exists; return its path."""
    return _build_host(rans_library_path(), RANS_SOURCE, "the rANS coder")


def build_jpeg() -> Path:
    """Compile ``csrc/jpeg.cc`` with g++ unless the keyed library already
    exists; return its path."""
    return _build_host(jpeg_library_path(), JPEG_SOURCE, "the JPEG decoder")


def build_png() -> Path:
    """Compile ``csrc/png.cc`` with g++ unless the keyed library already
    exists; return its path."""
    return _build_host(png_library_path(), PNG_SOURCE, "the PNG decoder")


def build_webp() -> Path:
    """Compile ``csrc/webp.cc`` with g++ unless the keyed library already
    exists; return its path."""
    return _build_host(webp_library_path(), WEBP_SOURCE, "the WebP decoder")


def build_tiff() -> Path:
    """Compile ``csrc/tiff.cc`` with g++ unless the keyed library already
    exists; return its path."""
    return _build_host(tiff_library_path(), TIFF_SOURCE, "the TIFF decoder")


def build_gif() -> Path:
    """Compile ``csrc/gif.cc`` with g++ unless the keyed library already
    exists; return its path."""
    return _build_host(gif_library_path(), GIF_SOURCE, "the GIF decoder")


def build_jpeg2000() -> Path:
    """Compile ``csrc/jpeg2000.cc`` with g++ unless the keyed library
    already exists; return its path."""
    return _build_host(jpeg2000_library_path(), JPEG2000_SOURCE, "the JPEG 2000 decoder",
                       JPEG2000_FLAGS)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    return declare_gdn(ctypes.CDLL(str(build())))


def declare_gdn(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signatures of ``csrc/gdn.cu``'s entry points."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.icat_gdn_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.icat_gdn_fwd.restype = i32
    lib.icat_gdn_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.icat_gdn_bwd.restype = i32
    for layout in (lib.icat_gdn_layout, lib.icat_gdn_bwd_layout):
        layout.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
        layout.restype = i32
    return lib
