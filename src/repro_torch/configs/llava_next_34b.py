"""llava-next-34b [vlm] — decoder LM backbone; anyres patch-embedding
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    n_frontend_tokens=2880,     # anyres tiling: 5 tiles x 576 patches
    rope_theta=5_000_000.0,
    sub_quadratic=False,
    notes="Patch embeddings are prepended to the token stream; assigned "
          "seq_len counts the combined stream length.",
)
