"""Host audio codecs of the port's stateful legs: G.722 and Opus."""

from libjitsi_tpu_torch.codecs.g722 import G722Decoder, G722Encoder  # noqa: F401
from libjitsi_tpu_torch.codecs.opus import (OpusDecoder,  # noqa: F401
                                            OpusEncoder, opus_available)
