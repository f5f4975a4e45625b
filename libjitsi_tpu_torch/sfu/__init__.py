from libjitsi_tpu_torch.sfu.cache import PacketCache  # noqa: F401
from libjitsi_tpu_torch.sfu.rtcp_termination import RtcpTermination  # noqa: F401
from libjitsi_tpu_torch.sfu.translator import RtpTranslator  # noqa: F401
