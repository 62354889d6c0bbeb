"""Architecture configs of the port (``--arch`` resolution)."""
