"""rwkv6-3b 'Finch' [ssm] — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # 2560 / 64 WKV heads
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attn_free=True,
    ssm=SSMConfig(state_dim=64),   # WKV state is head_dim x head_dim
    sub_quadratic=True,            # linear scan: long_500k RUNS
    notes="RWKV6 time-mix with data-dependent decay w = exp(-exp(.)); "
          "chunked WKV scan. Constant-size recurrent state for decode.",
)
