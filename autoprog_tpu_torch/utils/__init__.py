"""Logging and meters of the port (host code)."""
