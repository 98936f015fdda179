"""Batched KV-cache serving engine (the port's ``repro/serve/engine.py``):
prefill + decode with request slots.

  * :func:`make_serve_step` — the single-token decode step: one new token
    for every sequence in the batch against the cache.
  * :class:`ServeEngine` — slot-based batching: requests occupy fixed
    batch slots, a wave's prompts are left-padded with token 0 to one
    length, prefill fills the cache, decode advances all slots together,
    and the next wave takes the freed slots (continuous batching at wave
    granularity), as in the JAX package.

Sampling: greedy (argmax, first maximum on ties) or temperature.  The
temperature draw uses a :class:`torch.Generator` seeded per (seed, pos);
it cannot reproduce ``jax.random.categorical``'s bits, so parity with the
JAX engine holds for greedy decoding only.

Under an active sharding policy (:func:`repro_torch.distributed.sharding.
use_policy`) on a ('data', 'model') process mesh, the parameters are this
rank's shards: ``generate`` takes this rank's rows of the prompts (as
``batch_pspecs`` splits them), its cache holds the local kv heads, the
logits it samples are gathered over the model axis, and the tokens are
gathered over the batch axes, so every rank returns the same tokens.
(Temperature draws then use the per-(seed, pos) generator on each rank's
rows, not the unsharded run's rows.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed import tensor_parallel as tpl
from ..distributed.meshes import DeviceLike, resolve_device
from ..distributed.sharding import active_policy
from ..models import lm


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # [len] int32
    max_new_tokens: int
    temperature: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def make_serve_step(cfg: ArchConfig, *, dense_moe: bool = False
                    ) -> Callable:
    """step(params, cache, token [B], pos) -> (logits [B, V], cache)."""
    def step(params, cache, token, pos):
        return lm.decode_step(params, cfg, token, cache, pos,
                              dense_moe=dense_moe)
    return step


def step_generator(seed: int, pos: int, device) -> torch.Generator:
    """The generator of the draw at position ``pos`` (fixed per (seed, pos),
    whatever came before)."""
    mixed = np.random.SeedSequence([int(seed), int(pos)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator],
                 temperature: float) -> torch.Tensor:
    """logits [B, V] -> int32 token ids [B] (``gen`` is used only when
    ``temperature`` > 0)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


class ServeEngine:
    """Fixed-slot batched engine (one uniform position per step).

    ``device`` defaults to the CUDA card (raises without one); the
    parameters must already live there.  ``dense_moe`` runs MoE layers
    through the capacity-less dispatch; by default they take the sorted
    dispatch with one group, whose expert capacity drops token-choices
    (at 8 decode slots of deepseek-v2-lite, C = 1 a step).
    """

    def __init__(self, cfg: ArchConfig, params: Dict, batch_slots: int,
                 max_seq: int, dtype=torch.float32, *,
                 dense_moe: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.dense_moe = dense_moe
        self.seed = seed
        self.device = resolve_device(device)
        self._decode = make_serve_step(cfg, dense_moe=dense_moe)

    # -- batched generation (uniform prompts) -------------------------------
    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 temperature: float = 0.0, enc_frames=None,
                 prefix_embeds=None) -> np.ndarray:
        """prompts: [B, L] (uniform length).  ``enc_frames`` [B, S_enc, D]
        (enc-dec: required) and ``prefix_embeds`` [B, n_front, D] (VLM)
        are arrays or tensors, moved to the engine's device; the first
        decode position is L + n_front.  Returns [B, max_new_tokens]."""
        B, L = prompts.shape
        if B != self.B:
            raise ValueError(f"generate: {B} prompts for {self.B} slots")
        if self.cfg.family == "encdec" and enc_frames is None:
            raise ValueError(f"generate: {self.cfg.name} is an enc-dec "
                             f"model and needs enc_frames")
        policy = active_policy()
        n, idx = (1, 0) if policy is None else tpl.batch_split(policy, B)
        rows = slice(idx * (B // n), (idx + 1) * (B // n))   # this rank's
        front = {}
        for key, x in (("enc_frames", enc_frames),
                       ("prefix_embeds", prefix_embeds)):
            if x is not None:
                front[key] = torch.as_tensor(x, device=self.device)[rows]
        n_front = (prefix_embeds.shape[1] if prefix_embeds is not None
                   else 0)
        if L + n_front + max_new_tokens - 1 > self.max_seq:
            raise ValueError(f"generate: {n_front} prefix + {L} + "
                             f"{max_new_tokens} tokens do not fit max_seq "
                             f"{self.max_seq}")
        cache = lm.init_cache(self.cfg, B // n, self.max_seq, self.dtype,
                              device=self.device)
        tokens = torch.as_tensor(np.asarray(prompts[rows], np.int64),
                                 device=self.device)
        logits, cache = lm.prefill(self.params, self.cfg, tokens, cache,
                                   dense_moe=self.dense_moe, **front)

        def sample(logits, pos):
            gen = (step_generator(self.seed, pos, self.device)
                   if temperature > 0.0 else None)
            return sample_token(logits, gen, temperature)

        pos = L + n_front
        out = np.zeros((B // n, max_new_tokens), np.int32)
        tok = sample(logits, pos)
        for t in range(max_new_tokens):
            out[:, t] = tok.cpu().numpy()
            if t == max_new_tokens - 1:
                break
            logits, cache = self._decode(self.params, cache, tok.long(), pos)
            pos += 1
            tok = sample(logits, pos)
        if n > 1:
            out = tpl.gather_rows(policy, torch.as_tensor(
                out, device=self.device), B).cpu().numpy()
        return out

    # -- slot-based continuous batching --------------------------------------
    def serve(self, requests: List[Request]) -> List[Request]:
        """Run a request list to completion with slot reuse.  Prompts are
        left-padded with token 0 per wave; slots join at wave boundaries.
        No frontend inputs, as in the JAX engine: an enc-dec model raises
        (``generate`` takes its frames)."""
        queue = list(requests)
        while queue:
            wave = queue[: self.B]
            queue = queue[len(wave):]
            L = max(len(r.prompt) for r in wave)
            prompts = np.zeros((self.B, L), np.int32)
            for i, r in enumerate(wave):
                prompts[i, L - len(r.prompt):] = r.prompt   # left-pad
            steps = max(r.max_new_tokens for r in wave)
            toks = self.generate(prompts, steps,
                                 temperature=wave[0].temperature)
            for i, r in enumerate(wave):
                r.out_tokens = list(map(int, toks[i, : r.max_new_tokens]))
                r.done = True
        return requests
