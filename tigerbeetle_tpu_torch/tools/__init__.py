"""Measurement scripts of the port (host-side; see each module)."""
