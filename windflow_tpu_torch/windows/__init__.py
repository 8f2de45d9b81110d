"""windows of the port."""
