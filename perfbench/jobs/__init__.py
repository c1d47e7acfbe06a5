"""Jobs, one per kind of traffic, found by the traffic file's ``job``."""
