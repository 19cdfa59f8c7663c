"""Controllers of the port."""
