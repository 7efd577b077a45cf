"""Launch layer: the single-device serving entry point."""
