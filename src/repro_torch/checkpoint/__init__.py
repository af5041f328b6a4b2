"""Checkpoint reading (the reference trainer's npz + metadata format)."""
