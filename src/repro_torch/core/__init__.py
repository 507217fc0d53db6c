"""Server-side FL building blocks: SAA weights, flat aggregation, the
device stale cache, availability forecasting and APT (``repro.core``)."""
