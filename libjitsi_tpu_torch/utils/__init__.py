"""Host utilities (array-state checkpointing)."""
