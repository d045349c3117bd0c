"""Weights bridge: flax msgpack checkpoints and JAX parameter trees to the
port's ``state_dict``.

* ``read_msgpack`` decodes a flax ``serialization.to_bytes`` file in pure
  Python (maps, strings, binaries and the ndarray extension, type 1 =
  ``[shape, dtype, bytes]``), so the port needs neither ``msgpack`` nor
  ``flax``.  float16 leaves (the demo checkpoints are stored so) are upcast
  to float32, as the JAX loader does.
* ``params_from_jax`` inverts ``convert_state_dict`` of
  ``imagecompression_adversarial_tpu/io/convert.py``: flax names
  (``g_a_0/kernel``) become CompressAI names (``g_a.0.weight``), HWIO
  kernels become OIHW, and the transposed convs' HWIO(I, O) kernels IOHW.
"""

from __future__ import annotations

import re
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

# flax paths whose kernel belongs to a ConvTranspose2d, per family
# (io/convert.py _DECONV_PATHS)
_DECONV_PATHS = {
    "hyper": {"g_s_0", "g_s_2", "g_s_4", "g_s_6", "h_s_0", "h_s_2"},
}

# derived range-coder buffers of a CompressAI checkpoint (io/convert.py)
_SKIP_SUFFIXES = (
    "_quantized_cdf", "_offset", "_cdf_length", "scale_table", "target",
    "mask", "likelihood_lower_bound.bound", "lower_bound_scale.bound",
)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_SEQ_RE = re.compile(r"^(g_a|g_s|h_a|h_s)_(\d+)$")
_EB_RE = re.compile(r"^(matrix|bias|factor)_(\d+)$")


class _Reader:
    """Minimal msgpack decoder over one bytes buffer."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {
            0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q",
        }
        if b in fixed:
            return self.unpack(fixed[b])
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        lengths = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= b <= 0xC6:
            return self.take(self.unpack(lengths[b - 0xC4]))
        if 0xD9 <= b <= 0xDB:
            return self.take(self.unpack(lengths[b - 0xD9])).decode()
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(lengths[b - 0xDB]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(lengths[b - 0xDD]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xC7 <= b <= 0xC9:
            return self.ext(self.unpack(lengths[b - 0xC7]))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} at {self.pos - 1}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = _Reader(data).value()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        return arr[()] if code == _EXT_NPSCALAR else arr.copy()


def read_msgpack(path: str) -> Dict[str, Any]:
    """Decode a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: {len(reader.buf) - reader.pos} trailing bytes")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: top level is not a map")
    return tree


def params_from_jax(tree: Mapping[str, Any], arch: str = "hyper") -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree (numpy leaves) to the port's state_dict."""
    deconv = _DECONV_PATHS[arch]
    out: Dict[str, torch.Tensor] = {}
    for module, leaves in tree.items():
        for leaf, value in leaves.items():
            arr = np.asarray(value, np.float32)
            if module == "entropy_bottleneck":
                m = _EB_RE.match(leaf)
                name = f"_{m.group(1)}{m.group(2)}" if m else leaf
                out[f"entropy_bottleneck.{name}"] = torch.from_numpy(arr.copy())
                continue
            m = _SEQ_RE.match(module)
            if m is None:
                raise ValueError(f"unexpected parameter path {module}/{leaf}")
            prefix = f"{m.group(1)}.{m.group(2)}"
            if leaf == "kernel":
                perm = (2, 3, 0, 1) if module in deconv else (3, 2, 0, 1)
                out[f"{prefix}.weight"] = torch.from_numpy(arr.transpose(perm).copy())
            elif leaf in ("bias", "beta", "gamma"):
                out[f"{prefix}.{leaf}"] = torch.from_numpy(arr.copy())
            else:
                raise ValueError(f"unexpected parameter path {module}/{leaf}")
    return out


def state_dict_from_torch(ckpt: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A CompressAI-style checkpoint (raw or ``{"state_dict": ...}``, legacy
    ``net.`` prefix) without its derived range-coder buffers."""
    if isinstance(ckpt.get("state_dict"), Mapping):
        ckpt = ckpt["state_dict"]
    out = {}
    for key, value in ckpt.items():
        key = key[4:] if key.startswith("net.") else key
        if key.startswith("gaussian_conditional.") or key.endswith(_SKIP_SUFFIXES):
            continue
        if key.endswith(".gamma") and value.dim() == 4:
            value = value.reshape(value.shape[0], value.shape[1])
        out[key] = value.float()
    return out


def load_checkpoint(path: str, arch: str = "hyper") -> Dict[str, torch.Tensor]:
    """``.msgpack`` (flax) or ``.pth``/``.pth.tar`` (CompressAI) -> state_dict."""
    if path.endswith((".pth", ".tar")):
        return state_dict_from_torch(torch.load(path, map_location="cpu", weights_only=True))
    return params_from_jax(read_msgpack(path), arch)
