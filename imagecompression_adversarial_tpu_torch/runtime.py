"""Device choice and model loading (the part of
``imagecompression_adversarial_tpu/runtime.py`` that ``attack_rd`` needs)."""

from __future__ import annotations

from typing import Optional

import torch

from .config import Config
from .io.weights import load_checkpoint
from .models import CodecModel, init_model


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when CUDA
    is asked for and there is no card."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: -device cpu) to run on the CPU"
        )
    return dev


def load_model(cfg: Config, seed: int = 0) -> CodecModel:
    """The codec of ``cfg`` with its checkpoint (or seeded random
    parameters), frozen, on ``cfg.device`` in channels_last."""
    device = resolve_device(cfg.device)
    model = init_model(cfg.model, cfg.quality, seed)
    if cfg.checkpoint:
        model.load_state_dict(load_checkpoint(cfg.checkpoint, cfg.model), strict=True)
    model.requires_grad_(False)
    return model.to(device, memory_format=torch.channels_last).eval()
