"""Batched UDP engine and the media tick loop."""
