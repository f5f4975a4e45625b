"""SRTP for the PyTorch port (AES-CM + HMAC-SHA1 profiles)."""
