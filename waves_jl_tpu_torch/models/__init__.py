"""Surrogate models of the port."""
