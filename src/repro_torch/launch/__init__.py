"""Serving launcher (:mod:`.serve`)."""
