"""Batched serving of the port's LMs."""
