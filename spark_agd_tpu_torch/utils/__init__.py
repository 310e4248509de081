"""Utilities (this slice: the atomic npz writer, ``checkpoint``)."""
