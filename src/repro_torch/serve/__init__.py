"""Serving: the continuous-batching engine (``repro.serve``)."""
