"""Transform chain and SRTP."""
