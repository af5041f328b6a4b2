"""Model core of the port: ranks, thresholds, the MF model, rearrangement and the trainer."""
