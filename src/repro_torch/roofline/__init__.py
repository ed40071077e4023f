"""Roofline terms of the port (``roofline/analysis.py``)."""
