"""Launch layer: the single-device serving and training entry points."""
