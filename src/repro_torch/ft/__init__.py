"""Port of ``repro.ft``."""
