"""Timing utilities of the port."""
