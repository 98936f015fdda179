"""Flash attention: the hand-written Hopper kernel and its plain version."""
