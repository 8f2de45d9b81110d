"""utils of the port."""
