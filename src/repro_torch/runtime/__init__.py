"""Serve-side step functions of the port."""
