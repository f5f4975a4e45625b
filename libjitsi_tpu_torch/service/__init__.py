"""Stream registry (SSRC demux)."""
