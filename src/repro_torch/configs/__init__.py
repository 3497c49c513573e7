"""Dataset and render configurations of the port."""
