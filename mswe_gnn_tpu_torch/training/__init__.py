"""Autoregressive rollout, losses and training."""
