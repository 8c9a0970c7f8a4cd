"""Frozen operation and byte counts, one file per kernel op, one for the model."""
