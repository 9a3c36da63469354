"""Optimizers of the LM trainer."""
