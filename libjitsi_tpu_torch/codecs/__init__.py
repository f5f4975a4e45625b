"""Host audio codecs of the port's stateful legs: G.722 and Opus; GSM's
and Speex's availability probes (their coders are item 9's)."""

from libjitsi_tpu_torch.codecs.g722 import G722Decoder, G722Encoder  # noqa: F401
from libjitsi_tpu_torch.codecs.gsm import gsm_available  # noqa: F401
from libjitsi_tpu_torch.codecs.opus import (OpusDecoder,  # noqa: F401
                                            OpusEncoder, opus_available)
from libjitsi_tpu_torch.codecs.speex import speex_available  # noqa: F401
