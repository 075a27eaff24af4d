"""Launching worlds of ranks: the port of ``repro.launch``'s host tools."""
