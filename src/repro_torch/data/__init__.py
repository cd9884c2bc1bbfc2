"""Datasets for the port (copies of ``repro.data``: the time series and
the LM token pipeline)."""
