"""Row optimizers for the factor tables, and learning-rate schedules."""
