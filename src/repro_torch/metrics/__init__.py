"""Offline IR effectiveness metrics of the port (numpy only)."""
