"""Guidance synthesis of the port (numpy, click-derived families)."""
