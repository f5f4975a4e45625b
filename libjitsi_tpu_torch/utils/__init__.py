"""Host utilities: array-state checkpointing, metrics, pipeline tracing,
phase profiling, the flight recorder and logging."""
