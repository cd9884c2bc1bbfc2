"""Datasets for the port (copies of ``repro.data``)."""
