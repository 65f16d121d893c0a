"""Routes: one module per model family (see flux.py)."""
