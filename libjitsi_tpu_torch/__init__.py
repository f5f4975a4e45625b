"""libjitsi-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A package beside `libjitsi_tpu` (the JAX reference): host control planes
stay NumPy, tensors appear at the crypto boundary, and every TPU kernel
on a ported path is a hand-written CUDA kernel (`csrc/`) with a plain
PyTorch version beside it.  Entry points run on the card unless the
caller passes `device="cpu"`.  See ROADMAP.md for what is ported.

Public API shape mirrors the reference so capability parity is auditable
(counterpart: `libjitsi_tpu/__init__.py`): ``init()`` ↔
``LibJitsi.start()``; ``media_service()`` ↔ ``LibJitsi.getMediaService()``
(reference: org/jitsi/service/libjitsi/LibJitsi.java).
"""

__version__ = "0.1.0"

_media_service = None
_config_service = None
_file_access_service = None
_resources_service = None
_audio_notifier_service = None
_device = None
_started = False


def init(config=None, device=None):
    """Start the framework (reference: LibJitsi.start()).

    `device` is the one the next `media_service()` builds its service on:
    None means the card, and that service raises where there is none;
    the CPU runs only for ``device="cpu"``.  Calling `init` again merges
    `config` into the live store and, when `device` is given, keeps it
    for the next service built (the live one keeps its own).
    """
    global _started, _config_service, _device
    if device is not None:
        _device = device
    if _started:
        # Re-init with explicit config merges into the live store rather
        # than silently dropping it (easy to hit: any accessor auto-inits).
        if config:
            for k, v in config.items():
                _config_service.set(k, v)
        return
    from libjitsi_tpu_torch.core.config import ConfigurationService

    _config_service = ConfigurationService(overrides=config)
    _started = True


def stop():
    """Stop the framework (reference: LibJitsi.stop())."""
    global _started, _media_service, _config_service, \
        _file_access_service, _resources_service, _audio_notifier_service, \
        _device
    _media_service = None
    _config_service = None
    _file_access_service = None
    _resources_service = None
    _audio_notifier_service = None
    _device = None
    _started = False


def media_service():
    """Return the MediaService (reference: LibJitsi.getMediaService()),
    built on `init`'s device the first time."""
    global _media_service
    if not _started:
        init()
    if _media_service is None:
        from libjitsi_tpu_torch.service.media_service import MediaService

        _media_service = MediaService(configuration_service(), device=_device)
    return _media_service


def configuration_service():
    """Return the ConfigurationService
    (reference: LibJitsi.getConfigurationService())."""
    if not _started:
        init()
    return _config_service


def file_access_service():
    """Return the FileAccessService
    (reference: LibJitsi.getFileAccessService())."""
    global _file_access_service
    if _file_access_service is None:
        from libjitsi_tpu_torch.service.aux_services import FileAccessService

        _file_access_service = FileAccessService(configuration_service())
    return _file_access_service


def resource_management_service():
    """Return the ResourceManagementService
    (reference: LibJitsi.getResourceManagementService())."""
    global _resources_service
    if _resources_service is None:
        from libjitsi_tpu_torch.service.aux_services import \
            ResourceManagementService

        _resources_service = ResourceManagementService()
    return _resources_service


def audio_notifier_service():
    """Return the AudioNotifierService
    (reference: LibJitsi.getAudioNotifierService()), on the media
    service's audio system."""
    global _audio_notifier_service
    if _audio_notifier_service is None:
        from libjitsi_tpu_torch.service.aux_services import \
            AudioNotifierService

        _audio_notifier_service = AudioNotifierService(
            media_service().device_system.audio)
    return _audio_notifier_service
