"""Containers of the port's host code: Ogg."""
