"""Serve-path entry points (``repro.launch``, serve part)."""
