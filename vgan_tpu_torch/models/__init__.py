"""Generator networks and their initializers."""
