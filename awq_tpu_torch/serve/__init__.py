"""Serving front ends of the port (stdlib HTTP)."""
