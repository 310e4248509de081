"""Utilities: the atomic npz writer (``checkpoint``) and the structured
per-iteration log lines and records (``logging``)."""
