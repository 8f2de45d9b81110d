"""graph of the port."""
