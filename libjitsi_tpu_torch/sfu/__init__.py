from libjitsi_tpu_torch.sfu.cache import PacketCache  # noqa: F401
from libjitsi_tpu_torch.sfu.rtcp_termination import RtcpTermination  # noqa: F401
from libjitsi_tpu_torch.sfu.rtx import (RtxReceiver, RtxSender,  # noqa: F401
                                        decapsulate_batch,
                                        encapsulate_batch)
from libjitsi_tpu_torch.sfu.simulcast import SimulcastForwarder  # noqa: F401
from libjitsi_tpu_torch.sfu.svc import Vp9SvcForwarder  # noqa: F401
from libjitsi_tpu_torch.sfu.translator import RtpTranslator  # noqa: F401
