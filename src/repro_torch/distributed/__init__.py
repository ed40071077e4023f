"""Port of ``repro.distributed`` (the serve half of ``sharding.py``)."""
