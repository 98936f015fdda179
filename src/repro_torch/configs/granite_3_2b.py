"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    rope_theta=10_000.0,
    sub_quadratic=False,
)
