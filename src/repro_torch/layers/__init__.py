"""Port of ``repro.layers``."""
