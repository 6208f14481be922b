"""Launch drivers of the port."""
