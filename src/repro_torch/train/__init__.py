"""Training substrate of the port: AdamW, the microbatched train step,
atomic asynchronous checkpoints and the straggler and heartbeat
bookkeeping (the twin of ``repro.train``)."""
