"""Utilities of the port: the run's metric logger."""
