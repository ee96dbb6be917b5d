"""Optimizer, state, steps and checkpoints of the port."""
