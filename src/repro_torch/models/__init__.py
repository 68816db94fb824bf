"""Models of the port: the housing MLP and the dense decoder family."""
