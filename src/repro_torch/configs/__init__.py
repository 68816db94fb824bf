"""Model configurations of the port (the housing MLP in this slice)."""
