"""Optimizers and learning-rate schedules of the port."""
