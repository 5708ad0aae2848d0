"""Launchers: solving."""
