"""Architecture registry of the port: ``--arch <id>`` resolves here.

The same ten architectures as the JAX package's registry.  qwen2-72b and
llama3-405b (about 145 GB and 810 GB of bf16 weights) fit no single card:
they run at ``reduced()``, or split over the ranks of a model axis
(:mod:`repro_torch.distributed.tensor_parallel`).
"""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig  # noqa: F401
from .deepseek_v2_lite_16b import CONFIG as _dsv2
from .granite_3_2b import CONFIG as _granite
from .grok_1_314b import CONFIG as _grok
from .hymba_1_5b import CONFIG as _hymba
from .llama3_405b import CONFIG as _llama405
from .llava_next_34b import CONFIG as _llava
from .qwen2_1_5b import CONFIG as _qwen15
from .qwen2_72b import CONFIG as _qwen72
from .rwkv6_3b import CONFIG as _rwkv6
from .whisper_large_v3 import CONFIG as _whisper

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (
        _whisper, _rwkv6, _dsv2, _grok, _qwen15, _llama405, _qwen72,
        _granite, _llava, _hymba,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
