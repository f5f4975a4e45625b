"""Conference recording: rtpdump streams, a JSON event timeline and a
mixed-audio WAV (`recorder.py`), and the WebM muxer of a projected VP8
stream (`webm.py`)."""

from libjitsi_tpu_torch.recording.recorder import (  # noqa: F401
    Recorder,
    Synchronizer,
    WavWriter,
)
