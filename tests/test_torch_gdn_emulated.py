"""The GDN kernels of ``csrc/gdn.cu`` run on the CPU, through stand-ins for
the CUDA built-ins (``tests/gdn_host_emulation.h``): the file is compiled
with g++, each CUDA thread of a block runs as a host thread, barriers are
std::barriers and cp.async copies land when the thread waits for them (or
at once).  This checks on the CPU what the card tests check on the card
only: that every lane reads, writes and sums the elements it should, in
the order it should, and that the barriers and copy waits leave no tile
read before it is whole.  The kernels' outputs must equal, bit for bit,
plain loops that take the same chains with the same host arithmetic (the
backward: the norm as one FMA chain over i, dnorm @ gamma as one over o,
each elementwise step rounded); the card's rsqrtf and cuBLAS are not in
it, so this says nothing of those.  Shapes: every group width of the
backward (C padded to 32 .. 192), rows that are not a multiple of a tile,
groups that go round their two stages, unaligned rows, C 1 and 3.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from imagecompression_adversarial_tpu_torch.kernels import _build

HEADER = Path(__file__).with_name("gdn_host_emulation.h")
# the helpers whose bodies are PTX; the header stands in for them
PTX_HELPERS = ("cp_async4", "cp_async16", "cp_async16_zfill", "cp_async4_zfill",
               "cp_async_commit", "cp_async_wait_all", "cp_async_wait_but_last", "group_sync")


def host_source(source: str) -> str:
    """``csrc/gdn.cu`` for g++: the PTX helpers, the CUDA include, the
    dynamic shared-memory declarations and the launch syntax replaced."""
    source = source.replace("#include <cuda_runtime.h>\n", '#include "gdn_host_emulation.h"\n')
    for name in PTX_HELPERS:
        source, n = re.subn(r"__device__ __forceinline__ void " + name + r"\(.*?\n}\n", "",
                            source, flags=re.S)
        assert n == 1, f"{name}: {n} definitions"
    source, n = re.subn(r"extern __shared__ __align__\(16\) float smem\[\];",
                        "float* smem = emu::smem;", source)
    assert n == 2, f"{n} shared-memory declarations"
    source, n = re.subn(r"(\w+\([^;]*?\))<<<([^>]*)>>>\(", r"emu::launch(\1, \2, ", source)
    assert n == 2, f"{n} launches"
    assert "asm" not in source, "a PTX helper the header does not stand in for"
    return source


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the host rANS coder and this emulation"
    work = tmp_path_factory.mktemp("gdn_emulated")
    src = work / "gdn_host.cpp"
    src.write_text(host_source(_build.SOURCES[0].read_text()))
    out = work / "libgdn_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{HEADER.parent}", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = _build.declare_gdn(ctypes.CDLL(str(out)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.emu_ref_bwd.argtypes = [ptr] * 6 + [i32] * 3
    lib.emu_ref_fwd.argtypes = [ptr] * 4 + [i32] * 3
    lib.emu_set.argtypes = [i32, i32]
    return lib


def _rows(rows, c, offset, rng, scale):
    """A (rows, C) float32 array whose data starts ``offset`` floats past a
    16-byte boundary, and the buffer that holds it."""
    buf = np.zeros(rows * c + 8, np.float32)
    start = (-(buf.ctypes.data // 4)) % 4 + offset
    a = buf[start:start + rows * c].reshape(rows, c)
    a[:] = scale * rng.randn(rows, c)
    return a, buf


def _inputs(c, rows, offset, seed=0):
    """chip_smoke.py phase 3's recipe, made with numpy."""
    rng = np.random.RandomState(seed)
    (x, xb), (g, gb) = _rows(rows, c, offset, rng, 2.0), _rows(rows, c, offset, rng, 1.0)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.rand(c, c)).astype(np.float32)
    beta = (0.5 + rng.rand(c)).astype(np.float32)
    return x, g, gamma, beta, (xb, gb)


def _same_bits(a, b):
    return np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c, rows, offset, sms", [
    (192, 200, 0, 1), (128, 300, 0, 3), (128, 33, 0, 3), (1, 100, 0, 3), (3, 100, 0, 1),
    (130, 70, 0, 1), (191, 50, 0, 3), (16, 41, 0, 1), (64, 130, 0, 1), (96, 77, 0, 1),
    (160, 90, 0, 1), (128, 1000, 0, 1), (128, 77, 1, 1), (192, 50, 1, 1),
])
def test_emulated_backward_equals_plain_loop(lib, c, rows, offset, sms, inverse):
    """dx, dnorm and both, with copies landing at the wait and at once; one
    SM makes each group walk several tiles through its two stages."""
    x, g, gamma, beta, _keep = _inputs(c, rows, offset)
    ref_dx, ref_dn = np.empty((rows, c), np.float32), np.empty((rows, c), np.float32)
    lib.emu_ref_bwd(x.ctypes.data, gamma.ctypes.data, beta.ctypes.data, g.ctypes.data,
                    ref_dx.ctypes.data, ref_dn.ctypes.data, rows, c, int(inverse))
    for defer in (1, 0):
        lib.emu_set(sms, defer)
        for need_dx, need_dn in ((True, False), (False, True), (True, True)):
            dx = np.full((rows, c), np.nan, np.float32) if need_dx else None
            dn = np.full((rows, c), np.nan, np.float32) if need_dn else None
            rc = lib.icat_gdn_bwd(x.ctypes.data, gamma.ctypes.data, beta.ctypes.data,
                                  g.ctypes.data, None if dx is None else dx.ctypes.data,
                                  None if dn is None else dn.ctypes.data, rows, c, int(inverse),
                                  None)
            assert rc == 0
            for got, ref in ((dx, ref_dx), (dn, ref_dn)):
                assert got is None or _same_bits(got, ref), (defer, need_dx, need_dn)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c, rows, offset", [(192, 100, 0), (128, 300, 0), (3, 70, 0),
                                             (130, 33, 1)])
def test_emulated_forward_equals_plain_loop(lib, c, rows, offset, inverse):
    x, _, gamma, beta, _keep = _inputs(c, rows, offset)
    out, ref = np.empty((rows, c), np.float32), np.empty((rows, c), np.float32)
    lib.emu_set(3, 1)
    assert lib.icat_gdn_fwd(x.ctypes.data, gamma.ctypes.data, beta.ctypes.data,
                            out.ctypes.data, rows, c, int(inverse), None) == 0
    lib.emu_ref_fwd(x.ctypes.data, gamma.ctypes.data, beta.ctypes.data, ref.ctypes.data,
                    rows, c, int(inverse))
    assert _same_bits(out, ref)


@pytest.mark.parametrize("c, warps, smem", [(32, 8, 60032), (64, 16, 122112), (96, 15, 134784),
                                            (128, 16, 169472), (160, 15, 200064),
                                            (192, 12, 226560)])
def test_emulated_backward_layout(lib, c, warps, smem):
    """The backward's block at an H100's shared-memory limit (227 KB a
    block): C=128 16 warps, C=192 12 (gamma's 150.5 KB leaves room for two
    groups); a group is ceil(C / 32) warps with two stages of 16-row tiles.
    (The grid follows the SM count the first launch cached; the card test
    checks it.)"""
    out = (ctypes.c_int * 9)()
    assert lib.icat_gdn_bwd_layout(98304, c, 0, out) == 0
    tile, per_sm, _grid, got_smem, got_warps, group_warps, stages, lane_rows, lane_c = out
    assert (tile, got_smem, got_warps, group_warps, stages, lane_rows, lane_c) == (
        16, smem, warps, c // 32, 2, 4, 4)
    assert per_sm >= 1 and got_warps % group_warps == 0
