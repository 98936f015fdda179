"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every layer,
sliding-window attention + constant-state SSM => sub-quadratic long context.
[arXiv:2411.13676; hf]"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm=SSMConfig(state_dim=16, conv_width=4, dt_rank=48),
    sliding_window=2048,        # attention heads use SWA; SSM path is global
    sub_quadratic=True,         # long_500k RUNS
    notes="Per-layer output = mean of normalized attention-head and "
          "SSM-head branches (paper's parallel-head fusion).",
)
