"""Data pipelines (port of ``repro.data``): the synthetic token corpora."""
