from libjitsi_tpu_torch.bwe.rate_stats import RateStatistics  # noqa: F401
from libjitsi_tpu_torch.bwe.remote_estimator import RemoteBitrateEstimator  # noqa: F401
from libjitsi_tpu_torch.bwe.send_side import SendSideBandwidthEstimation  # noqa: F401
from libjitsi_tpu_torch.bwe.batched import BatchedRemoteBitrateEstimator  # noqa: F401
