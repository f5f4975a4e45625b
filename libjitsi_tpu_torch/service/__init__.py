"""Stream registry (SSRC demux), the bridges and the operations plane."""
from libjitsi_tpu_torch.service.bridge import ConferenceBridge  # noqa: F401
from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge  # noqa: F401
from libjitsi_tpu_torch.service.obs_server import (  # noqa: F401
    ObservabilityServer)
from libjitsi_tpu_torch.service.supervisor import (  # noqa: F401
    BridgeSupervisor, SupervisorConfig)
