"""Synthetic datasets of the port (numpy generators, torch tensors out)."""
