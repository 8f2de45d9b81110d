"""Applications built on the port's public API."""
