"""Deterministic, checkpointable synthetic data pipeline (the port of
``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step): it is drawn from a host
:class:`torch.Generator` seeded from the pair, so the pipeline's
checkpoint state is just the step counter and a resumed run reproduces the
uninterrupted token stream bit for bit.  The draws are made on the host
and moved to the pipeline's device, so a batch is the same on the card
and on the CPU.  The distributions, keys, shapes and dtypes are the JAX
package's; the bits are not ``jax.random``'s (the parity tests feed JAX's
batches to both trainers).

The epoch-level *global shuffle* runs through the coded MapReduce engine
(:mod:`repro_torch.mapreduce`) when ``scheme_params`` is given:
``shuffled_epoch_order`` derives a deterministic permutation (numpy, equal
to the JAX package's) while the shuffle's bytes are the paper's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.params import SchemeParams
from ..distributed.meshes import DeviceLike, resolve_device
from ..models.frontends import audio_frames, vision_patches


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict:
        return {"step": torch.tensor(self.step, dtype=torch.int32)}

    @staticmethod
    def from_dict(d: Dict) -> "PipelineState":
        return PipelineState(int(d["step"]))


def step_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of batch ``step``: seeded from (seed, step)."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))


@dataclasses.dataclass(frozen=True)
class SyntheticPipeline:
    """Zipf-ish synthetic token stream shaped for an architecture, on
    ``device`` (default: the CUDA card; raises without one)."""
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    dtype: object = torch.float32
    device: DeviceLike = None

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        gen = step_generator(self.seed, step)
        cfg = self.cfg
        dev = resolve_device(self.device)
        n_front = (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
        s_text = self.seq_len - n_front
        # zipf-like marginal over the vocab: exponentiate a uniform
        # uniform on [1e-6, 1), as jax.random.uniform(minval=1e-6) maps it
        u = 1e-6 + (1.0 - 1e-6) * torch.rand((self.global_batch,
                                               s_text + 1), generator=gen)
        toks = torch.clamp((u ** -0.7 - 1.0) * cfg.vocab_size * 0.01,
                           max=cfg.vocab_size - 1).to(torch.int32)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
               "loss_mask": torch.ones((self.global_batch, s_text),
                                       dtype=torch.float32)}
        if cfg.frontend == "vision":
            out["prefix_embeds"] = vision_patches(gen, cfg,
                                                  self.global_batch,
                                                  self.dtype)
        if cfg.family == "encdec":
            out["enc_frames"] = audio_frames(gen, cfg, self.global_batch,
                                             self.dtype)
        return {k: v.contiguous().to(dev) for k, v in out.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def shuffled_epoch_order(n_samples: int, epoch: int,
                         scheme_params: Optional[SchemeParams] = None,
                         seed: int = 0, *,
                         device: DeviceLike = None) -> np.ndarray:
    """Deterministic epoch permutation (numpy, the JAX package's), derived
    through the MapReduce engine's histogram job when ``scheme_params`` is
    given (the shuffle traffic accounted under the paper's cost model; the
    job runs on ``device``, default the CUDA card)."""
    rng = np.random.default_rng((seed, epoch))
    perm = rng.permutation(n_samples)
    if scheme_params is not None:
        from ..mapreduce.engine import run_job
        from ..mapreduce.jobs import histogram_job
        p = scheme_params
        ids = perm[: (n_samples // p.N) * p.N].reshape(p.N, -1)
        run_job(histogram_job(), ids.astype(np.int32), p, scheme="hybrid",
                device=device)
    return perm
