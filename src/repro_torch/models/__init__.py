"""Models of the port (the housing MLP in this slice; the zoo is slice H)."""
