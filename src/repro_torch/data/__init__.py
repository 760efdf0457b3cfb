"""Data for the port: copies of the reference's numpy generators."""
