"""Architecture configurations of the port (torch twins of ``repro.configs``)."""
