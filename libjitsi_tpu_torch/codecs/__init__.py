"""Host codecs: the audio codecs of the port's stateful legs (G.722,
Opus, GSM, Speex), the libvpx binding (VP8/VP9) and the RTP payload
formats of the video plane (`vp8`, `vp9`, `h264`).  The ctypes bindings
load their library at first use, so this package imports on a host that
lacks libvpx or libavcodec."""

from libjitsi_tpu_torch.codecs.g722 import G722Decoder, G722Encoder  # noqa: F401
from libjitsi_tpu_torch.codecs.gsm import GsmCodec, gsm_available  # noqa: F401
from libjitsi_tpu_torch.codecs.opus import (OpusDecoder,  # noqa: F401
                                            OpusEncoder, opus_available)
from libjitsi_tpu_torch.codecs.speex import (SpeexDecoder,  # noqa: F401
                                             SpeexEncoder, speex_available)
from libjitsi_tpu_torch.codecs.vpx import (VpxDecoder,  # noqa: F401
                                           VpxEncoder, vpx_available)
