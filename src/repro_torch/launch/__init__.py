"""Launcher: the serving entry point."""
