"""Optimizers as pure functions over nested dicts of tensors."""
