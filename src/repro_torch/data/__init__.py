"""Synthetic corpora and the coded block partitioner (NumPy)."""
