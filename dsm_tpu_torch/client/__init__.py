"""Clients of the port's server (counterpart of ``dsm_tpu/client``): the
streaming STT and TTS clients, the duplex terminal UI, and live audio I/O.

They need ``aiohttp`` and ``msgpack`` where a session runs (imported there),
and ``sounddevice`` for a microphone or a speaker.  The Opus wire is not
ported: a request for it raises :class:`OpusUnavailable`."""


class OpusUnavailable(NotImplementedError):
    """The Opus wire (OggOpus pages or messages) is not ported; the clients
    speak raw pcm."""

    def __init__(self, what: str):
        super().__init__(f"{what}: the Opus wire (OggOpus) is not ported to "
                         f"dsm_tpu_torch; use raw pcm")


from .stt import SttClient, SttEvent  # noqa: E402
from .tts import TtsClient  # noqa: E402
