"""Atomic, checksummed step checkpoints of a parameter and optimizer
tree."""
