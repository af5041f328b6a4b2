"""Model core of the port: ranks, thresholds, and the MF model's serving subset."""
