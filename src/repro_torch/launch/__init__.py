"""Launch layer: the serving and training entry points, the device
meshes they run on, and the HLO text analyses."""
