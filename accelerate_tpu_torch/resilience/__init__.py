"""Checkpoint integrity: the manifest (:mod:`.manifest`)."""
