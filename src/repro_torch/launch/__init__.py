"""Launchers: the LM serving loop (``serve``)."""
