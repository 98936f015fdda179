"""The LM stack of the port (dense GQA, MoE with GQA or MLA attention, and
RWKV6 families)."""
