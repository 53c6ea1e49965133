"""Clients of the port's server (counterpart of ``dsm_tpu/client``): the
streaming STT and TTS clients, the duplex terminal UI, and live audio I/O.

They need ``aiohttp`` and ``msgpack`` where a session runs (imported there),
``sounddevice`` for a microphone or a speaker, and libopus and libogg for the
Opus wire (``utils/opus.py``)."""

from .stt import SttClient, SttEvent
from .tts import TtsClient
