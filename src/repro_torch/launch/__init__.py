"""Launchers: the serve launcher (``--mode delivery``, synchronous)."""
