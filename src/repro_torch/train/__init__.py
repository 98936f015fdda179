"""Training of the port's LMs: optimizers, the train step with the paper's
data-parallel gradient sync, checkpoints and restarts."""
