"""Launchers: solving and serving."""
