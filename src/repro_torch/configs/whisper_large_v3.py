"""whisper-large-v3 [audio] — enc-dec transformer backbone; the conv/mel
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,                # decoder layers
    encoder_layers=32,
    encoder_seq=1500,           # 30 s of audio after the conv frontend
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,              # full MHA (GQA kv=20)
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    qkv_bias=True,
    frontend="audio",
    sub_quadratic=False,        # full attention: long_500k skipped
    notes="Assigned seq_len applies to the DECODER stream; encoder is the "
          "fixed 1500-frame stub. Paper model caps decoder at 448 tokens; "
          "the assigned shapes stress the same backbone at longer lengths.",
)
