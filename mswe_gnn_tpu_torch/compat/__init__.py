"""Bridges to parameters written by the JAX package."""
