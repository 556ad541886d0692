"""Autoregressive rollout."""
