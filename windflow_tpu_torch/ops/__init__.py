"""ops of the port."""
