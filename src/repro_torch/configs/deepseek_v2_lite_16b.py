"""deepseek-v2-lite-16b [moe] — MLA attention (kv_lora=512) + fine-grained
MoE (2 shared + 64 routed, top-6). [arXiv:2405.04434; hf]"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,              # MLA: every head reads the shared kv_lora
    head_dim=128,               # nope head dim
    d_ff=10944,                 # dense FFN of the first layer
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128, q_lora_rank=None),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
                  first_dense_layers=1),
    sub_quadratic=False,
    notes="MLA compressed KV cache (kv_lora+rope dims instead of full KV) — "
          "dominant decode-memory win. MoE dispatch is a literal shuffle; "
          "hybrid-coded/hierarchical all-to-all applies (DESIGN.md §4).",
)
