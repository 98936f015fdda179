"""The LM stack of the port (dense GQA and RWKV6 families)."""
