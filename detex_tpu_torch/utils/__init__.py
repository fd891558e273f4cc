"""Utility subsystems of the port: checkpointing, metrics, NaN guards."""
