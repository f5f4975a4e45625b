"""Packet batches, RTP index arithmetic and device selection."""
