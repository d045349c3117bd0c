"""Weights bridge: flax msgpack checkpoints and JAX parameter trees to the
port's ``state_dict``.

* ``read_msgpack`` decodes a flax ``serialization.to_bytes`` file in pure
  Python (maps, strings, binaries and the ndarray extension, type 1 =
  ``[shape, dtype, bytes]``), so the port needs neither ``msgpack`` nor
  ``flax``.  float16 leaves (the demo checkpoints are stored so) are upcast
  to float32, as the JAX loader does.
* ``params_from_jax`` inverts ``convert_state_dict`` of
  ``imagecompression_adversarial_tpu/io/convert.py``: flax names
  (``g_a_0/conv1/kernel``) become CompressAI names (``g_a.0.conv1.weight``),
  a subpel conv's ``conv`` becomes ``0`` (``h_s_2/conv`` -> ``h_s.2.0``),
  HWIO kernels become OIHW, and the transposed convs' HWIO(I, O) kernels
  IOHW.  The attention blocks of cheng2020-attn/-gmm have no CompressAI
  layout in the reference's converter; ``g_a_attn_1`` becomes
  ``g_a.attn_1``, and those two families load from flax trees only, as do
  the adapter families (nlaic, invcompress, tic, hific, fic), whose
  transforms keep their flax names (``g_a_nlam_1`` -> ``g_a.nlam_1``,
  ``enc_0_1/attn/qkv`` -> ``enc_0_1.attn.qkv``).
* ``load_checkpoint`` also reads the port's own training checkpoints, and
  the codec of a GAN training file (``cli/train_hific.py``).
* ``write_msgpack`` is ``read_msgpack``'s inverse: the bytes of
  ``flax.serialization.to_bytes``.  ``flax_params`` gives a module's
  parameters as a flax tree (the inverse layouts of ``_leaf``), and
  ``codec_to_jax`` checks that tree against ``params_from_jax``.
* The GAN discriminator and the classifier have flax trees of their own:
  ``discriminator_from_jax`` (its ``params`` and the ``SpectralNorm_i``
  stats) and ``classifier_from_jax``.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

# flax paths whose kernel belongs to a ConvTranspose2d, per family
# (io/convert.py _DECONV_PATHS for the families with a CompressAI layout)
_BALLE_SYNTHESIS = {"g_s_0", "g_s_2", "g_s_4", "g_s_6"}
_MEAN_SCALE_HYPER = {"h_s_0", "h_s_2"}
_DECONV_PATHS = {
    "factorized": _BALLE_SYNTHESIS,
    "hyper": _BALLE_SYNTHESIS | _MEAN_SCALE_HYPER,
    "context": _BALLE_SYNTHESIS | _MEAN_SCALE_HYPER,
    "cheng2020": set(),
    "debug": {"g_s_0", "h_s_0", "h_s_2"},
}
# families that load from flax trees only, and their transposed convs
_FLAX_ONLY = {
    "cheng2020-attn": set(),
    "cheng2020-gmm": set(),
    "nlaic": _BALLE_SYNTHESIS | _MEAN_SCALE_HYPER,
    "fic": _BALLE_SYNTHESIS | _MEAN_SCALE_HYPER,
    "tic": _MEAN_SCALE_HYPER | {f"unembed_{i}" for i in range(4)},
    "hific": _MEAN_SCALE_HYPER | {f"generator/up_{i}" for i in range(4)},
    "invcompress": set(),
}

# derived range-coder buffers of a CompressAI checkpoint (io/convert.py)
_SKIP_SUFFIXES = (
    "_quantized_cdf", "_offset", "_cdf_length", "scale_table", "target",
    "mask", "likelihood_lower_bound.bound", "lower_bound_scale.bound",
)

# the file a training step directory of train/checkpoint.py holds
TRAIN_CHECKPOINT = "checkpoint.pt"
# the top level of a GAN training file (cli/train_hific.py)
GAN_KEYS = ("generator", "discriminator")

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_SEQ_RE = re.compile(r"^(g_a|g_s|h_a|h_s|entropy_parameters)_(\d+|attn_\d+|nlam_\d+)$")
# top-level flax modules kept under their own name: the context model, and
# the adapter families' transforms (invcompress ``inv``, hific ``encoder``
# and ``generator``, fic ``context``, tic's stages)
_NAMED_RE = re.compile(r"^(context_prediction|inv|encoder|generator|context"
                       r"|(un)?embed_\d+|(enc|dec)_\d+_\d+)$")
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


class _Writer:
    """Minimal msgpack encoder: maps with string keys and ndarrays, as
    ``msgpack.packb(..., use_bin_type=True)`` lays them out."""

    def __init__(self):
        self.parts = []

    def head(self, n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
        """A length header: the fix form under ``fix_max``, else the first
        of the 8/16/32-bit forms (``codes``, ``None`` where there is none)
        that holds ``n``."""
        if n < fix_max:
            self.parts.append(bytes([fix | n]))
            return
        for code, fmt in zip(codes, ("B", "H", "I")):
            if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
                self.parts.append(bytes([code]) + struct.pack(">" + fmt, n))
                return
        raise ValueError(f"msgpack length {n} too large")

    def value(self, v: Any) -> None:
        if isinstance(v, Mapping):
            self.head(len(v), 0x80, 16, (None, 0xDE, 0xDF))
            for key, item in v.items():
                self.value(str(key))
                self.value(item)
        elif isinstance(v, str):
            raw = v.encode()
            self.head(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
            self.parts.append(raw)
        elif isinstance(v, bytes):
            self.head(len(v), 0x00, 0, (0xC4, 0xC5, 0xC6))
            self.parts.append(v)
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 16, (None, 0xDC, 0xDD))
            for item in v:
                self.value(item)
        elif isinstance(v, int) and 0 <= v < 1 << 64:
            if v < 128:
                self.parts.append(bytes([v]))
            else:
                for code, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
                    if v < 1 << (8 * struct.calcsize(fmt)):
                        self.parts.append(bytes([code]) + struct.pack(">" + fmt, v))
                        break
        elif isinstance(v, (np.ndarray, np.generic)):
            code = _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR
            inner = _Writer()
            inner.value([list(v.shape), v.dtype.name, np.ascontiguousarray(v).tobytes()])
            data = b"".join(inner.parts)
            fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            if len(data) in fixext:
                self.parts.append(bytes([fixext[len(data)], code]))
            else:
                self.head(len(data), 0x00, 0, (0xC7, 0xC8, 0xC9))
                self.parts.append(struct.pack(">b", code))
            self.parts.append(data)
        else:
            raise TypeError(f"cannot write {type(v).__name__} to a flax msgpack")


def write_msgpack(path: str, tree: Mapping[str, Any]) -> None:
    """Write a nested dict of numpy arrays as ``flax.serialization.to_bytes``
    does (ndarrays as msgpack extension type 1, numpy scalars as type 3),
    creating the file's directory."""
    writer = _Writer()
    writer.value(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(writer.parts))


def _insert(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if path[-1] in tree:
        raise ValueError(f"two parameters map to flax path {'/'.join(path)}")
    tree[path[-1]] = value


def flax_params(model: nn.Module) -> Dict[str, Any]:
    """A module's parameters as a flax tree of float32 numpy arrays: OIHW
    conv weights as HWIO ``kernel`` (IOHW transposed convs too), Linear
    weights as ``(in, out)`` ``kernel``, LayerNorm weights as ``scale``;
    ``g_a.0`` becomes ``g_a_0`` and the entropy bottleneck's ``_matrix0``
    ``matrix_0``.  Buffers are left out."""
    kinds = {name: type(m) for name, m in model.named_modules()}
    tree: Dict[str, Any] = {}
    for key, p in model.named_parameters():
        arr = p.detach().cpu().numpy().astype(np.float32)
        owner, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        kind = kinds[owner]
        if leaf == "weight" and arr.ndim == 4:
            perm = (2, 3, 0, 1) if issubclass(kind, nn.ConvTranspose2d) else (2, 3, 1, 0)
            leaf, arr = "kernel", arr.transpose(perm)
        elif leaf == "weight" and issubclass(kind, nn.Linear):
            leaf, arr = "kernel", arr.T
        elif leaf == "weight" and issubclass(kind, nn.LayerNorm):
            leaf = "scale"
        parts = flax_module_path(owner)
        if parts[:1] == ["entropy_bottleneck"]:
            m = re.match(r"^_(matrix|bias|factor)(\d+)$", leaf)
            leaf = f"{m.group(1)}_{m.group(2)}" if m else leaf
        _insert(tree, tuple(parts) + (leaf,), np.ascontiguousarray(arr))
    return tree


def flax_module_path(name: str) -> List[str]:
    """The flax path of a submodule, by its torch name: a transform's
    ``g_a.0`` is ``g_a_0`` (``h_s.2``, ``g_a.attn_1`` likewise); other
    names keep their parts."""
    parts = name.split(".") if name else []
    if len(parts) > 1 and _SEQ_RE.match(f"{parts[0]}_{parts[1]}"):
        parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
    return parts


def codec_to_jax(model: nn.Module, arch: str) -> Dict[str, Any]:
    """The codec's flax tree (``flax_params``), checked to map back onto
    its state_dict through ``params_from_jax``; raises for a family whose
    names the tree cannot carry (subpel convs, invcompress's ``conv3``)."""
    tree = flax_params(model)
    back = params_from_jax(tree, arch)
    state = model.state_dict()
    if back.keys() != state.keys() or not all(
            torch.equal(back[k], state[k].detach().cpu().float()) for k in state):
        raise ValueError(f"{arch!r}: the flax tree does not map back onto the model's state_dict")
    return tree


def discriminator_from_jax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``HiFiCDiscriminator`` state_dict from flax's
    ``params`` (``latent_proj``, ``conv_0`` .. ``conv_3``, ``logits``) and
    ``batch_stats`` (``SpectralNorm_i/<conv>/kernel/u`` and ``.../sigma``)."""
    out: Dict[str, torch.Tensor] = {}
    for module, node in params.items():
        for leaf, value in node.items():
            (name,), arr = _leaf(module, leaf, np.asarray(value, np.float32), False)
            out[f"{module}.{name}"] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    for node in batch_stats.values():
        for path, value in node.items():
            module, _, leaf = path.split("/")
            out[f"{module}.{leaf}"] = torch.from_numpy(np.array(value, np.float32))
    return out


def classifier_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``MLPClassifier`` state_dict from a flax tree of
    ``Dense_i`` layers: kernels ``(in, out)`` transposed, biases as they
    are."""
    out: Dict[str, torch.Tensor] = {}
    for module, node in params.items():
        if not re.match(r"^Dense_\d+$", module):
            raise ValueError(f"unexpected classifier parameter path {module}")
        for leaf, value in node.items():
            (name,), arr = _leaf(module, leaf, np.asarray(value, np.float32), False)
            out[f"{module}.{name}"] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


def _flax_leaves(node: Mapping[str, Any], names: Tuple[str, ...], path: Tuple[str, ...]):
    """(torch name parts, flax path of the leaf's module, leaf name, value)
    of every leaf under ``node``; a node whose only child is ``conv`` is a
    subpel conv, whose conv is ``.0`` in CompressAI's
    ``Sequential(conv, PixelShuffle)``."""
    subpel = set(node) == {"conv"}
    for key, value in node.items():
        if isinstance(value, Mapping):
            yield from _flax_leaves(value, names + ("0" if subpel else key,), path + (key,))
        else:
            yield names, "/".join(path), key, value


def _leaf(path: str, leaf: str, arr: np.ndarray,
          deconv: bool) -> Tuple[Tuple[str, ...], np.ndarray]:
    """(torch name parts, array) of one flax leaf, or raises: conv kernels
    HWIO -> OIHW (IOHW for a transposed conv), Dense kernels (in, out) ->
    (out, in), LayerNorm ``scale`` -> ``weight``, invcompress's
    ``conv3_kernel``/``conv3_bias`` -> ``conv3.weight``/``.bias``; GDN and
    ChannelNorm ``beta``/``gamma``, ``rel_bias`` and the invertible 1x1
    conv's (in, out) ``weight`` keep their names and layouts."""
    if leaf in ("kernel", "conv3_kernel"):
        name = ("conv3", "weight") if leaf == "conv3_kernel" else ("weight",)
        if arr.ndim == 2:
            return name, arr.T
        return name, arr.transpose((2, 3, 0, 1) if deconv else (3, 2, 0, 1))
    if leaf == "conv3_bias":
        return ("conv3", "bias"), arr
    if leaf == "scale":
        return ("weight",), arr
    if leaf in ("bias", "beta", "gamma", "rel_bias", "weight"):
        return (leaf,), arr
    raise ValueError(f"unexpected parameter path {path}/{leaf}")


def params_from_jax(tree: Mapping[str, Any], arch: str = "hyper") -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree (numpy leaves) to the port's state_dict;
    raises on a leaf it cannot place or on two leaves with one name."""
    deconv = _DECONV_PATHS[arch] if arch in _DECONV_PATHS else _FLAX_ONLY[arch]
    out: Dict[str, torch.Tensor] = {}
    for module, node in tree.items():
        if module == "entropy_bottleneck":
            for leaf, value in node.items():
                m = _EB_RE.match(leaf)
                name = f"_{m.group(1)}{m.group(2)}" if m else leaf
                out[f"entropy_bottleneck.{name}"] = torch.from_numpy(np.array(value, np.float32))
            continue
        m = _SEQ_RE.match(module)
        if m is None and not _NAMED_RE.match(module):
            raise ValueError(f"unexpected parameter path {module}")
        prefix = module if m is None else f"{m.group(1)}.{m.group(2)}"
        for names, path, leaf, value in _flax_leaves(node, (prefix,), (module,)):
            parts, arr = _leaf(path, leaf, np.asarray(value, np.float32), path in deconv)
            key = ".".join(names + parts)
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
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
    """A state_dict from a flax ``.msgpack``, a CompressAI ``.pth``/``.pth.tar``,
    or this port's training checkpoint: its ``checkpoint.pt``, or the step
    or ``best_loss`` directory that holds one (``train/checkpoint.py``),
    whose ``state.params`` are this port's own names."""
    if os.path.isdir(path):
        inner = os.path.join(path, TRAIN_CHECKPOINT)
        if not os.path.isfile(inner):
            raise ValueError(f"{path} is a directory without a {TRAIN_CHECKPOINT}: give a step "
                             "or best_loss directory of this port's trainer, or a file")
        path = inner
    if path.endswith(".pt"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in payload["state"]["params"].items()}
    if path.endswith((".pth", ".tar")):
        if arch not in _DECONV_PATHS:
            raise ValueError(f"{arch!r} has no CompressAI layout; load it from a flax .msgpack")
        return state_dict_from_torch(torch.load(path, map_location="cpu", weights_only=True))
    tree = read_msgpack(path)
    if set(tree) == set(GAN_KEYS):  # cli/train_hific.py's file: its codec
        tree = tree["generator"]
    return params_from_jax(tree, arch)
