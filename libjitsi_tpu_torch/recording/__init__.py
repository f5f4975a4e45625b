"""Conference recording: rtpdump streams, a JSON event timeline and a
mixed-audio WAV (`recorder.py`)."""

from libjitsi_tpu_torch.recording.recorder import (  # noqa: F401
    Recorder,
    Synchronizer,
    WavWriter,
)
