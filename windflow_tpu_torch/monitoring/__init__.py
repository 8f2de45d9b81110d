"""Monitoring planes of the port (ROADMAP A8: only the key-compaction
probe so far)."""
