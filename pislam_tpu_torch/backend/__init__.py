"""Backend pieces of the VO path: motion-only bundle adjustment."""
