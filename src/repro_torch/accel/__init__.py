"""Approximate units, their library, the five accelerators and the
synthesis oracle."""
