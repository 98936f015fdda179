"""Modality frontend stubs (the port's ``repro/models/frontends.py``): the
audio and vision entries specify the transformer backbone only, so the
frontends hand it precomputed frame or patch embeddings drawn from a
:class:`torch.Generator` on the generator's device, and
:func:`train_batch_specs` gives the dry run's shape-only batch
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig


def _normal(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


def audio_frames(gen: torch.Generator, cfg: ArchConfig, batch: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Stub for Whisper's conv1/conv2(mel) output: [B, encoder_seq, D]."""
    return _normal(gen, (batch, cfg.encoder_seq, cfg.d_model), dtype)


def vision_patches(gen: torch.Generator, cfg: ArchConfig, batch: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Stub for the LLaVA anyres CLIP+projector output:
    [B, n_frontend_tokens, D]."""
    return _normal(gen, (batch, cfg.n_frontend_tokens, cfg.d_model), dtype)


def frontend_inputs(gen: torch.Generator, cfg: ArchConfig, batch: int,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The stub inputs a model's ``forward`` / ``prefill`` take besides
    tokens: ``prefix_embeds`` for a vision model, ``enc_frames`` for an
    enc-dec one, nothing for a text model."""
    out = {}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = vision_patches(gen, cfg, batch, dtype)
    if cfg.family == "encdec":
        out["enc_frames"] = audio_frames(gen, cfg, batch, dtype)
    return out


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for one training batch of ``shape``
    (the JAX package's ``ShapeDtypeStruct`` specs): its keys and shapes,
    with the dtypes :func:`make_train_batch` gives (int64 tokens)."""
    B, S = shape.global_batch, shape.seq_len
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    s_text = S - n_front
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    specs = {"tokens": meta((B, s_text), torch.int64),
             "targets": meta((B, s_text), torch.int64),
             "loss_mask": meta((B, s_text), torch.float32)}
    if cfg.frontend == "vision":
        specs["prefix_embeds"] = meta((B, n_front, cfg.d_model), dtype)
    if cfg.family == "encdec":
        specs["enc_frames"] = meta((B, cfg.encoder_seq, cfg.d_model), dtype)
    return specs


def make_train_batch(gen: torch.Generator, cfg: ArchConfig, batch: int,
                     seq: int, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Concrete synthetic batch of ``seq`` positions (a vision model's
    patch prefix included) on the generator's device."""
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    s_text = seq - n_front
    toks = torch.randint(0, cfg.vocab_size, (batch, s_text + 1),
                         generator=gen, device=gen.device)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "loss_mask": torch.ones((batch, s_text), dtype=torch.float32,
                                   device=gen.device)}
    out.update(frontend_inputs(gen, cfg, batch, dtype))
    return out
