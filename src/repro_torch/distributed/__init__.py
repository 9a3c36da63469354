"""Fault handling of the evaluation stack: injected faults, retry and
health monitoring."""
