"""Host audio codecs of the port's stateful legs: G.722, Opus, GSM and
Speex."""

from libjitsi_tpu_torch.codecs.g722 import G722Decoder, G722Encoder  # noqa: F401
from libjitsi_tpu_torch.codecs.gsm import GsmCodec, gsm_available  # noqa: F401
from libjitsi_tpu_torch.codecs.opus import (OpusDecoder,  # noqa: F401
                                            OpusEncoder, opus_available)
from libjitsi_tpu_torch.codecs.speex import (SpeexDecoder,  # noqa: F401
                                             SpeexEncoder, speex_available)
