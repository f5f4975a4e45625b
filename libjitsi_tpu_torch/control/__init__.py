"""Keying controls: SDES (RFC 4568), DTLS-SRTP (RFC 5764) and ZRTP (RFC
6189), each a key provider whose completed control hands
`MediaStream.start(srtp_control=...)` its `srtp_keys()`."""

from libjitsi_tpu_torch.control.dtls import (  # noqa: F401
    DtlsAssociationTable,
    DtlsSrtpEndpoint,
    StubDtlsEndpoint,
    generate_certificate,
    is_dtls,
)
from libjitsi_tpu_torch.control.sdes import CryptoAttribute, SdesControl  # noqa: F401
from libjitsi_tpu_torch.control.zrtp import ZidCache, ZrtpEndpoint  # noqa: F401
