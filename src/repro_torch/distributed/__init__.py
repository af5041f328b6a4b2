"""Fault tolerance of the training launcher (multi-device code comes later)."""
