"""Checkpoints in the reference trainer's npz + metadata format, read and written."""
