"""Keying controls.  SDES (RFC 4568) is ported; DTLS-SRTP and ZRTP wait
for ROADMAP Queue 1 item 9 (`MediaStream.start(srtp_control=...)` takes
any completed control with `srtp_keys()` meanwhile)."""

from libjitsi_tpu_torch.control.sdes import CryptoAttribute, SdesControl  # noqa: F401
