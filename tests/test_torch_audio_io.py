"""The port's live-audio plumbing (``dsm_tpu_torch/client/audio_io.py``)
against the JAX package's, without hardware: the streaming resampler bit for
bit in the same chunks, the prebuffered playback ring's prebuffer, underrun
and overflow, the level meter, a fake ``sounddevice``, and the CLI's
``--mic`` / ``--play`` exiting 2 with the error where no backend exists."""

import numpy as np
import pytest

from dsm_tpu.client import audio_io as jaio
from dsm_tpu_torch import cli as tcli
from dsm_tpu_torch.client import audio_io as aio


@pytest.mark.parametrize("src,dst", [(24_000, 24_000), (48_000, 24_000), (44_100, 24_000),
                                     (16_000, 24_000), (24_000, 48_000), (8_000, 24_000)])
def test_resampler_chunked_equals_jax_bit_for_bit(src, dst):
    """The same signal in the same odd-sized chunks (1 sample at times, so a
    call can carry its one sample of history and give nothing) through both
    resamplers: every chunk's output equal, bit for bit."""
    rng = np.random.default_rng(src + dst)
    x = (np.sin(2 * np.pi * 440.0 * np.arange(src) / src)
         + 0.1 * rng.standard_normal(src)).astype(np.float32)
    ours, theirs = aio.StreamingResampler(src, dst), jaio.StreamingResampler(src, dst)
    i, total = 0, 0
    while i < len(x):
        n = int(rng.choice([1, 2, int(rng.integers(3, 1024))]))
        a, b = ours.process(x[i : i + n]), theirs.process(x[i : i + n])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        total += len(a)
        i += n
    assert abs(total - dst) <= 2


def test_resampler_rate_and_content():
    src, dst = 48_000, 24_000
    t = np.arange(src) / src
    y = aio.StreamingResampler(src, dst).process(np.sin(2 * np.pi * 100.0 * t).astype(np.float32))
    assert abs(len(y) - dst) <= 2
    np.testing.assert_allclose(y, np.sin(2 * np.pi * 100.0 * np.arange(len(y)) / dst), atol=1e-2)
    with pytest.raises(ValueError):
        aio.StreamingResampler(0, 24_000)


@pytest.mark.parametrize("mod", [aio, jaio], ids=["port", "jax"])
def test_playback_prebuffer_and_underrun(mod):
    ring = mod.PlaybackBuffer(prebuffer=100)
    ring.push(np.ones(60, np.float32))
    np.testing.assert_array_equal(ring.pull(50), np.zeros(50))  # below the prebuffer
    assert ring.buffered == 60
    ring.push(np.full(50, 2.0, np.float32))  # crosses it: playback starts
    out = ring.pull(80)
    np.testing.assert_array_equal(out[:60], np.ones(60))
    np.testing.assert_array_equal(out[60:], np.full(20, 2.0))
    out = ring.pull(64)  # past the end: zero-filled, one underrun, prebuffering again
    np.testing.assert_array_equal(out[:30], np.full(30, 2.0))
    np.testing.assert_array_equal(out[30:], np.zeros(34))
    assert ring.underruns == 1
    ring.push(np.ones(10, np.float32))
    np.testing.assert_array_equal(ring.pull(10), np.zeros(10))
    ring.flush_start()  # the end of a stream plays a tail below the prebuffer
    np.testing.assert_array_equal(ring.pull(10), np.ones(10))
    ring.push(np.ones(5, np.float32))
    np.testing.assert_array_equal(ring.drain_remaining(), np.ones(5))
    assert ring.buffered == 0


@pytest.mark.parametrize("mod", [aio, jaio], ids=["port", "jax"])
def test_playback_drop_on_overflow(mod):
    ring = mod.PlaybackBuffer(prebuffer=10, max_buffer=100)
    ring.push(np.ones(90, np.float32))
    ring.push(np.ones(20, np.float32))  # would pass max_buffer: dropped
    assert ring.dropped == 20 and ring.buffered == 90


def test_level_meter_matches_jax():
    ours, theirs = aio.AudioLevel(smoothing=0.5), jaio.AudioLevel(smoothing=0.5)
    for x in (np.zeros(100), np.ones(100), np.full(100, 0.5), np.zeros(0)):
        assert ours.update(x.astype(np.float32)) == theirs.update(x.astype(np.float32))
    lvl = aio.AudioLevel(smoothing=0.0)
    assert lvl.update(np.full(100, 0.5, np.float32)) == pytest.approx(-6.02, abs=0.1)


def test_without_backend_mic_and_speaker_raise(monkeypatch):
    monkeypatch.setattr(aio, "_sounddevice", lambda: None)
    assert aio.backend_name() is None
    with pytest.raises(aio.AudioUnavailable, match="sounddevice"):
        aio.MicSource()
    with pytest.raises(aio.AudioUnavailable, match="sounddevice"):
        aio.SpeakerSink()


@pytest.mark.parametrize("argv", [
    ["stt-client", "--mic", "--url", "ws://127.0.0.1:1/x"],
    ["tts-client", "hello", "out.wav", "--play", "--url", "ws://127.0.0.1:1/x"],
])
def test_cli_audio_flags_exit_2_without_backend(monkeypatch, capsys, tmp_path, argv):
    """No backend: exit code 2 and the error on stderr, before any connection
    (the URL's port refuses)."""
    monkeypatch.setattr(aio, "_sounddevice", lambda: None)
    monkeypatch.chdir(tmp_path)
    assert tcli.main(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "sounddevice" in err
    assert not (tmp_path / "out.wav").exists()


def test_cli_tui_exits_2_without_a_terminal(monkeypatch, capsys):
    """No terminal to draw on (pytest's captured stdout; TERM unset): exit
    code 2 and the error, before any connection."""
    monkeypatch.delenv("TERM", raising=False)
    monkeypatch.setattr(aio, "_sounddevice", lambda: None)
    assert tcli.main(["tui", "--url", "ws://127.0.0.1:1/api/chat", "--seconds", "0.1"]) == 2
    assert capsys.readouterr().err.startswith("error: the terminal UI needs a terminal")


def test_mic_source_with_fake_backend(monkeypatch):
    """48 kHz stereo blocks through a fake sounddevice come out as 24 kHz
    frames of 1,920 samples, as the JAX MicSource gives them."""

    class FakeStream:
        def __init__(self, samplerate, channels, device, callback):
            self.callback = callback

        def start(self):
            pass

        def stop(self):
            pass

        def close(self):
            pass

    class FakeSd:
        def query_devices(self, device, kind):
            return {"default_samplerate": 48_000.0, "max_input_channels": 2}

        InputStream = FakeStream

    t = np.arange(48_000) / 48_000
    x = np.sin(2 * np.pi * 220.0 * t).astype(np.float32)
    block = np.stack([x, x], axis=1)
    got = {}
    for name, mod in (("port", aio), ("jax", jaio)):
        monkeypatch.setattr(mod, "_sounddevice", lambda: FakeSd())
        with mod.MicSource() as mic:
            for i in range(0, len(x), 4800):
                mic._stream.callback(block[i : i + 4800], 4800, None, None)
            got[name] = [mic.read_frame(timeout=0.1) for _ in range(12)]
    assert all(f is not None and f.shape == (1920,) for f in got["port"])
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)
