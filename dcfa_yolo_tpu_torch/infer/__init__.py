"""Serving path of the port."""
