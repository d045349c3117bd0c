"""Real bitstreams: the codec's transforms on its device, the rANS coder on
the host (port of ``imagecompression_adversarial_tpu/entropy/codec.py``).

The equivalent of CompressAI's ``compress()``/``decompress()``.  Every
structure of the port's families but ``none`` (debug) is supported:
``factorized``, ``scale_hyper``, ``mean_scale`` (tic, hific), ``context``
and ``context_gmm`` (the wavefront loop of ``entropy/autoregressive.py``)
and fic's ``context4``: one pass of its checkerboard context model to
encode, four (one a phase) to decode.

A stream decodes only if the decoder's ``h_s(z_hat)`` and context heads
reproduce the encoder's to the bit.  So every call runs under
``coder_settings``: cuDNN neither benchmarks nor picks a nondeterministic
algorithm, TF32 is off, and every tensor a transform takes is
channels_last.  A stream then decodes on the kind of device that wrote it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.fic import PHASE_ORDER
from . import rans
from .autoregressive import ARWeights, ar_decode, ar_decode_gmm, ar_encode, ar_encode_gmm
from .gaussian import SCALE_BOUND, SCALES_MAX
from .tables import (build_eb_tables, build_gc_tables, build_gmm_cdf_rows, gc_build_indexes,
                     ideal_bits, stack_rows)


@contextlib.contextmanager
def coder_settings():
    """cuDNN deterministic without benchmarking and TF32 off for the block;
    the previous settings come back afterwards."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.benchmark, cudnn.deterministic = False, True
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc_flat(t: torch.Tensor) -> torch.Tensor:
    """(1, C, h, w) -> its values in (h, w, C) order, flat: the coding order."""
    return t.permute(0, 2, 3, 1).reshape(-1)


class RealCodec:
    """Bit-exact encode and decode around a codec module."""

    SUPPORTED = ("factorized", "scale_hyper", "mean_scale", "context", "context_gmm", "context4")

    def __init__(self, module):
        structure = getattr(module, "entropy_structure", "none")
        if structure not in self.SUPPORTED:
            raise NotImplementedError(
                f"real-coder path does not support {type(module).__name__} "
                f"(entropy_structure={structure!r})"
            )
        self.module = module
        self.structure = structure
        self.device = next(module.parameters()).device
        with coder_settings():
            self.eb_tables = build_eb_tables(module.entropy_bottleneck)
            self.medians = torch.from_numpy(self.eb_tables["medians"]).to(self.device)
            if structure != "factorized":
                self.gc_tables = build_gc_tables()
            if structure in ("context", "context_gmm"):
                self.ar_weights = ARWeights(module)

    # ---------------------------------------------------------------- EB

    def _eb_encode(self, z: torch.Tensor, stats: Dict) -> Tuple[bytes, torch.Tensor, float]:
        """Code ``z`` (1, C, h, w) channel by channel with the factorized
        model; returns (string, z_hat, ideal bits)."""
        t = self.eb_tables
        medians = self.medians.reshape(1, -1, 1, 1)
        values = z - medians
        sym = torch.round(values)
        host = torch.stack([_nhwc_flat(sym), _nhwc_flat(values)]).cpu().numpy()
        symbols = host[0].astype(np.int32)
        indexes = np.tile(np.arange(z.shape[1], dtype=np.int32), symbols.size // z.shape[1])
        tables = (t["cdfs"], t["cdf_sizes"], t["offsets"])
        bits = ideal_bits(symbols, indexes, *tables)
        stats.update(ideal_bits=bits, symbols=symbols, indexes=indexes, values=host[1])
        return rans.encode_with_indexes(symbols, indexes, *tables), _cl(sym + medians), bits

    def _eb_decode(self, string: bytes, shape) -> torch.Tensor:
        t = self.eb_tables
        h, w = shape
        c = t["medians"].size
        indexes = np.tile(np.arange(c, dtype=np.int32), h * w)
        symbols = rans.decode_with_indexes(string, indexes, t["cdfs"], t["cdf_sizes"],
                                           t["offsets"])
        sym = torch.from_numpy(symbols.reshape(1, h, w, c).astype(np.float32)).to(self.device)
        return _cl(sym.permute(0, 3, 1, 2) + self.medians.reshape(1, -1, 1, 1))

    # ------------------------------------------------------ context4 (fic)

    @staticmethod
    def _phases(h: int, w: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(i, j) index arrays of each checkerboard phase, in decode order."""
        ii, jj = np.mgrid[0:h, 0:w]
        return [np.nonzero((ii % 2 == a) & (jj % 2 == b)) for a, b in PHASE_ORDER]

    @staticmethod
    def _phase_rows(scales: torch.Tensor, means: torch.Tensor, ii, jj):
        """CDF rows of one phase's symbols, position-major then channel:
        single Gaussians with the scales clamped to [SCALE_BOUND,
        SCALES_MAX], the estimate's range; the fractional means stay in
        the rows, since the symbols are ``round(y)``."""
        host = torch.stack([scales[0, :, ii, jj], means[0, :, ii, jj]]).cpu().numpy()
        sc, mu = (a.T.reshape(-1, 1) for a in host)
        return build_gmm_cdf_rows(np.clip(sc, SCALE_BOUND, SCALES_MAX), mu, np.zeros_like(mu))

    def _context4_encode(self, y: torch.Tensor, hyper: torch.Tensor,
                         stats: Dict) -> Tuple[bytes, torch.Tensor]:
        """One full context pass over ``round(y)``: a phase's parameters see
        only the phases before it, so they equal the decoder's passes."""
        y_q = torch.round(y)
        scales, means = self.module.context(y_q, hyper)
        symbols, rows, sizes, offsets = [], [], [], []
        for ii, jj in self._phases(*y.shape[2:]):
            r, s, o = self._phase_rows(scales, means, ii, jj)
            symbols.append(y_q[0, :, ii, jj].t().reshape(-1))
            rows.append(r)
            sizes.append(s)
            offsets.append(o)
        symbols = torch.cat(symbols).cpu().numpy().astype(np.int32)
        tables = (stack_rows(rows), np.concatenate(sizes), np.concatenate(offsets))
        indexes = np.arange(symbols.size, dtype=np.int32)
        stats.update(ideal_bits=ideal_bits(symbols, indexes, *tables), symbols=symbols,
                     indexes=indexes, cdfs=tables[0], cdf_sizes=tables[1], offsets=tables[2])
        return rans.encode_with_indexes(symbols, indexes, *tables), _cl(y_q)

    def _context4_decode(self, string: bytes, hyper: torch.Tensor) -> torch.Tensor:
        """Four context passes, each decoding one phase onto the canvas."""
        _, _, h, w = hyper.shape
        canvas = _cl(torch.zeros(1, self.module.M, h, w, device=self.device))
        with rans.StreamingDecoder(string) as dec:
            for ii, jj in self._phases(h, w):
                scales, means = self.module.context(canvas, hyper)
                rows, sizes, offsets = self._phase_rows(scales, means, ii, jj)
                sym = dec.decode(np.arange(sizes.size, dtype=np.int32), rows, sizes, offsets)
                values = torch.from_numpy(sym.reshape(len(ii), -1).astype(np.float32))
                canvas[0, :, ii, jj] = values.t().to(self.device)
        return canvas

    # ------------------------------------------------------------ public

    def compress(self, x: torch.Tensor, trace: Optional[Dict] = None) -> Dict:
        """``x`` (1, 3, H, W) in [0, 1] -> ``{"strings", "shape", "ideal_bits"}``.

        ``ideal_bits`` is the cost of exactly the symbols written under
        exactly their CDF rows (``tables.ideal_bits``).  ``trace``, when
        given, receives the encoder's latent ``y_hat`` and, for each stream
        (``"y"``, ``"z"``), what was coded, in coding order.
        """
        trace = {} if trace is None else trace
        trace["y"], trace["z"] = {}, {}
        with coder_settings():
            y = self.module.g_a(_cl(x.to(self.device, torch.float32)))
            if self.structure == "factorized":
                y_string, trace["y_hat"], bits = self._eb_encode(y, trace["y"])
                return {"strings": [y_string], "shape": tuple(y.shape[2:]), "ideal_bits": bits}

            z = self.module.h_a(torch.abs(y) if self.structure == "scale_hyper" else y)
            z_string, z_hat, z_bits = self._eb_encode(z, trace["z"])
            hyper = self.module.h_s(z_hat)
            st = trace["y"]
            if self.structure == "context_gmm":
                y_string, trace["y_hat"] = ar_encode_gmm(y, hyper, self.ar_weights, stats=st)
            elif self.structure == "context":
                y_string, trace["y_hat"] = ar_encode(y, hyper, self.ar_weights, self.gc_tables,
                                                     stats=st)
            elif self.structure == "context4":
                y_string, trace["y_hat"] = self._context4_encode(y, hyper, st)
            else:  # hyperpriors: scales (and means) from h_s
                y_string, trace["y_hat"] = self._hyper_encode(y, hyper, st)
        return {"strings": [y_string, z_string], "shape": tuple(z.shape[2:]),
                "ideal_bits": st["ideal_bits"] + z_bits}

    def _split_hyper(self, hyper: torch.Tensor):
        """(scales, means) of ``h_s``'s output: the scale hyperprior's means
        are zero, the mean-scale one's come second."""
        if self.structure == "mean_scale":
            return hyper.chunk(2, dim=1)
        return hyper, torch.zeros_like(hyper)

    def _hyper_encode(self, y: torch.Tensor, hyper: torch.Tensor,
                      stats: Dict) -> Tuple[bytes, torch.Tensor]:
        """Symbols ``round(y - means)`` under the scale-table rows; returns
        the string and the encoder's latent ``sym + means``."""
        t = self.gc_tables
        scales, means = self._split_hyper(hyper)
        values = y - means
        sym = torch.round(values)
        host = torch.stack([_nhwc_flat(scales), _nhwc_flat(sym), _nhwc_flat(values)]).cpu().numpy()
        symbols = host[1].astype(np.int32)
        indexes = gc_build_indexes(host[0], t["scale_table"])
        tables = (t["cdfs"], t["cdf_sizes"], t["offsets"])
        stats.update(ideal_bits=ideal_bits(symbols, indexes, *tables), symbols=symbols,
                     indexes=indexes, values=host[2], scales=host[0])
        return rans.encode_with_indexes(symbols, indexes, *tables), _cl(sym + means)

    def decode_latent(self, strings: List[bytes], shape) -> torch.Tensor:
        """The latent ``y_hat`` (1, M, h, w) that ``strings`` code."""
        with coder_settings():
            if self.structure == "factorized":
                (y_string,) = strings
                return self._eb_decode(y_string, shape)
            y_string, z_string = strings
            hyper = self.module.h_s(self._eb_decode(z_string, shape))
            if self.structure == "context_gmm":
                return ar_decode_gmm(y_string, hyper, self.ar_weights)
            if self.structure == "context":
                return ar_decode(y_string, hyper, self.ar_weights, self.gc_tables)
            if self.structure == "context4":
                return self._context4_decode(y_string, hyper)
            t = self.gc_tables
            scales, means = self._split_hyper(hyper)
            indexes = gc_build_indexes(_nhwc_flat(scales).cpu().numpy(), t["scale_table"])
            symbols = rans.decode_with_indexes(y_string, indexes, t["cdfs"], t["cdf_sizes"],
                                               t["offsets"])
            _, m, h, w = scales.shape
            y_hat = torch.from_numpy(symbols.reshape(1, h, w, m).astype(np.float32))
            return _cl(y_hat.to(self.device).permute(0, 3, 1, 2) + means)

    def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
        """``g_s(y_hat)`` clipped to [0, 1]."""
        with coder_settings():
            return torch.clamp(self.module.g_s(_cl(y_hat)), 0.0, 1.0)

    def decompress(self, strings: List[bytes], shape) -> torch.Tensor:
        """Inverse of :meth:`compress`: the reconstruction (1, 3, H, W) in
        [0, 1] on the codec's device."""
        return self.synthesize(self.decode_latent(strings, shape))

    @staticmethod
    def real_bpp(result: Dict, num_pixels: int) -> float:
        return sum(len(s) for s in result["strings"]) * 8.0 / num_pixels

    def table_bpp(self, x: torch.Tensor, num_pixels: int) -> Optional[float]:
        """Bits a pixel of the symbols ``compress`` writes for ``x`` under the
        table rows it codes them with, for the scale hyperprior (the JAX
        package's table audit); None for the other structures, whose
        ``compress`` result carries the same audit as ``ideal_bits``."""
        if self.structure != "scale_hyper":
            return None
        return self.compress(x)["ideal_bits"] / num_pixels
