"""RTP header codec (host NumPy)."""
