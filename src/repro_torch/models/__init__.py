"""Models of the port (the recsys serving path so far)."""
