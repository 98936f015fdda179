"""The RWKV6 WKV scan: the hand-written Hopper kernel and its plain version."""
