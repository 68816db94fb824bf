"""Launch scripts of the port."""
