"""Output storage: the local-disk store of rendered images."""
