"""Mesh construction for the port's runtime."""
