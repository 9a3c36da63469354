"""Deterministic image data for the functional model."""
