"""parallel of the port."""
