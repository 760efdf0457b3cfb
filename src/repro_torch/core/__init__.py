"""Configuration and device helpers of the port."""
