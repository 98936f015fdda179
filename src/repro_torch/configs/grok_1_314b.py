"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(n_routed=8, n_shared=0, top_k=2, d_ff_expert=32768),
    sub_quadratic=False,
)
