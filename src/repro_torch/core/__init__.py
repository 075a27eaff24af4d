"""Core of the port: Eq. 1 transform, storage formats, layout, cache ops, index."""
