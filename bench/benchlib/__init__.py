"""The benchmark's own library: the cell's files by name (``spec``), the
configuration and the seeded weights (``model``), the run (``serve``), the
profiled slice (``profile``), the roofline arithmetic (``roofline``) and the
comparison that decides ``correct`` (``check``)."""
