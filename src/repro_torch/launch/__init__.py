"""Launchers (port): the serving CLI."""
