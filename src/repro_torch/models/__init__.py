"""The model zoo of the port (``repro.models``' serving paths): layers,
attention and the int8 KV cache, MoE, Mamba2 and xLSTM blocks, the
decoder-only, hybrid, recurrent and encoder-decoder assemblies, and the
model registry."""
