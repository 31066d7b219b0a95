"""Checkpoints: nested dicts of tensors <-> .npz with a .json sidecar."""
