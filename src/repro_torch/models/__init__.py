"""The decoder zoo of the port: layers, attention, the dense decoder and
the model registry (``repro.models``' dense paths)."""
