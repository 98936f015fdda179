"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose model family the port runs are listed; the
JAX package's other configs wait for their families (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig  # noqa: F401
from .deepseek_v2_lite_16b import CONFIG as _dsv2
from .granite_3_2b import CONFIG as _granite
from .grok_1_314b import CONFIG as _grok
from .qwen2_1_5b import CONFIG as _qwen15
from .rwkv6_3b import CONFIG as _rwkv6

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (_qwen15, _rwkv6, _dsv2, _grok, _granite)}

# the JAX package's other architectures and their families
JAX_ONLY = {"whisper-large-v3": "encdec", "llava-next-34b": "vlm",
            "hymba-1.5b": "hybrid", "llama3-405b": "dense",
            "qwen2-72b": "dense"}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in JAX_ONLY:
        raise KeyError(f"arch {name!r} (family {JAX_ONLY[name]}) is not "
                       f"ported yet; ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
