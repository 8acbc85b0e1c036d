"""Launchers: the LM serving loop (``serve``) and the training loop
(``train``)."""
