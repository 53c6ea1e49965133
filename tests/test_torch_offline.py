"""The port's offline entry points (``dsm_tpu_torch/offline.py``), its audio
decoding (``utils/audio.py``, ``utils/flac.py``, ``utils/codecs.py``) and
``cli stt`` / ``cli tts`` against the JAX package, at small sizes on the CPU.

* ``decode_audio`` and ``decode_audio_bytes`` of wav (16-bit mono, 32-bit
  stereo, resampled) and flac (hand-built streams of tests/test_flac.py)
  bit for bit the JAX functions; mp3 too where libmpg123 loads; an ogg/opus
  file too (vorbis tried first, then opus) where libopus loads;
  ``write_wav``, ``read_wav``, ``resample`` and ``audio_level_db`` equal.
* ``transcribe_files`` (two files of different lengths on the batch
  dimension), ``transcribe_file`` and the frame-at-a-time path against the
  JAX ``transcribe_files`` / ``transcribe_file`` on small engines, greedy
  and seeded: the same words with the same times; the VAD steps' counters
  equal and their probabilities within 1e-5 (f32 sums in other orders).
* ``synthesize_file`` and ``synthesize_jsonl`` (one-session and batched
  engines) against the JAX functions: the same words and durations, the
  wav samples within 4 of 32768 (the pcm's 1e-4 bar of
  tests/test_torch_tts_single.py, written as 16-bit).
* ``cli stt`` and ``cli tts`` with ``--device cpu`` on small TOMLs: the
  printed JSON is what the offline functions return.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dsm_tpu import offline as joffline
from dsm_tpu.server import batched_asr as jBA
from dsm_tpu.server.tts_batched import BatchedTtsEngine as JaxBatchedTts
from dsm_tpu.server.tts_module import TtsEngine as JaxTts
from dsm_tpu.utils import audio as jAU
from dsm_tpu.utils import codecs as jcodecs
from dsm_tpu.utils import tokenizer as jTOK
from dsm_tpu_torch import cli as tcli
from dsm_tpu_torch import offline as toffline
from dsm_tpu_torch.server import batched_asr as tBA
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server.config import Config
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.server import tts_module as tTM
from dsm_tpu_torch.utils import audio as tAU
from dsm_tpu_torch.utils import codecs as tcodecs
from dsm_tpu_torch.utils import tokenizer as tTOK
from tests.test_asr import small_asr_cfg
from tests.test_flac import W, crc16, frame_header, streaminfo, subframe_fixed, subframe_verbatim
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_asr import port_asr_cfg
from tests.test_torch_cli import _dump
from tests.test_torch_moshi import np_lm_params, np_mimi_params
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_mimi_cfg
from tests.test_torch_tts_serving import port_tts_cfg, spm_bytes
from tests.test_torch_tts_single import _small_module, _small_v0_1
from tests.test_tts import small_tts_cfg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAV_LSB = 4  # 1e-4 of pcm in 16-bit samples, rounded up


# ---------------------------------------------------------------------------
# Audio decoding
# ---------------------------------------------------------------------------


def _flac_bytes():
    block = 96
    t = np.arange(block)
    left = (4000 * np.sin(t / 5.0)).astype(int)
    right = (3000 * np.cos(t / 3.0)).astype(int)
    w = W()
    frame_header(w, block, ch_code=1)
    subframe_fixed(w, left.tolist(), order=2)
    subframe_verbatim(w, right.tolist())
    crc16(w)
    return b"fLaC" + streaminfo(48000, 2, 16, block) + w.bytes()


def _wavs(tmp_path):
    rng = np.random.default_rng(0)
    mono = str(tmp_path / "mono.wav")
    jAU.write_wav(mono, rng.uniform(-0.9, 0.9, 4800).astype(np.float32), 16_000)
    stereo = str(tmp_path / "stereo.wav")
    import wave

    with wave.open(stereo, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(4)
        w.setframerate(24_000)
        w.writeframes(rng.integers(-2**31, 2**31 - 1, (2400, 2)).astype("<i4").tobytes())
    flac = tmp_path / "x.flac"
    flac.write_bytes(_flac_bytes())
    return [mono, stereo, str(flac)]


@pytest.mark.parametrize("rate", [24_000, 16_000])
def test_decode_audio_and_bytes_match_jax(tmp_path, rate):
    for path in _wavs(tmp_path):
        want = jAU.decode_audio(path, rate)
        got = tAU.decode_audio(path, rate)
        assert got.dtype == np.float32 and got.ndim == 1 and len(got) > 0
        np.testing.assert_array_equal(got, want)
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(tAU.decode_audio_bytes(data, rate),
                                      jAU.decode_audio_bytes(data, rate))
    with pytest.raises(NotImplementedError, match="supported"):
        tAU.decode_audio(str(tmp_path / "x.aiff"))
    with pytest.raises(NotImplementedError, match="unrecognised"):
        tAU.decode_audio_bytes(b"\x00" * 16)


def test_wav_io_resample_and_level_match_jax(tmp_path):
    pcm = (np.sin(np.linspace(0, 300, 4800)) * 1.2).astype(np.float32)  # clips
    pj, pt = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    jAU.write_wav(pj, pcm, 24_000)
    tAU.write_wav(pt, pcm, 24_000)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read() == tAU.wav_bytes(pcm, 24_000)
    back, sr = tAU.read_wav(pt)
    want, sr_j = jAU.read_wav(pj)
    assert sr == sr_j == 24_000
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(tAU.resample(pcm, 24_000, 16_000),
                                  jAU.resample(pcm, 24_000, 16_000))
    assert tAU.resample(pcm, 8_000, 8_000) is not None
    assert tAU.audio_level_db(pcm) == jAU.audio_level_db(pcm)


def test_mp3_decodes_as_in_jax_where_libmpg123_loads():
    assert tcodecs.mp3_available() == jcodecs.mp3_available()
    path = os.path.join(ROOT, "audio", "speech-synthetic.mp3")
    if not tcodecs.mp3_available():
        with pytest.raises(NotImplementedError, match="libmpg123"):
            tAU.decode_audio(path)
        return
    np.testing.assert_array_equal(tAU.decode_audio(path, 16_000),
                                  jAU.decode_audio(path, 16_000))
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(tAU.decode_audio_bytes(data), jAU.decode_audio_bytes(data))
    if tcodecs.lame_available():
        sine = (0.5 * np.sin(np.arange(12_000) / 4.0)).astype(np.float32)
        enc = tcodecs.encode_mp3(sine, 24_000)
        assert enc == jcodecs.encode_mp3(sine, 24_000)


def test_ogg_opus_file_decodes_as_jax_decodes(tmp_path):
    from dsm_tpu.utils import opus as jopus

    if not jopus.available():
        pytest.skip("libopus or libogg unavailable")
    sine = (0.5 * np.sin(np.arange(12_000) / 4.0)).astype(np.float32)
    data = jopus.OggOpusEncoder().encode(sine, eos=True)
    p = tmp_path / "tone.ogg"
    p.write_bytes(data)
    for rate in (24_000, 16_000):
        want = jAU.decode_audio(str(p), rate)
        got = tAU.decode_audio(str(p), rate)
        assert got.dtype == np.float32 and len(got) == len(want) > 0
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(tAU.decode_audio_bytes(data, rate).view(np.int32),
                                      jAU.decode_audio_bytes(data, rate).view(np.int32))
    assert len(tAU.decode_audio(str(p))) == len(sine) // 480 * 480


# ---------------------------------------------------------------------------
# Offline STT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def asr_pair():
    return _asr_engines(0.0), _asr_engines(0.7)


def _asr_engines(temperature):
    cfg = dataclasses.replace(small_asr_cfg(), temperature=temperature)
    params = {"mimi": np_mimi_params(cfg.mimi, 1), "lm": np_lm_params(cfg.lm, 2)}
    saved = jBA.FRAME_SIZE
    jBA.FRAME_SIZE = cfg.mimi.frame_size
    try:
        ej = jBA.BatchedAsrEngine(cfg, params, batch_size=1)
    finally:
        jBA.FRAME_SIZE = saved
    ej.tokenizer = jTOK.FallbackTokenizer()
    et = tBA.BatchedAsrEngine(port_asr_cfg(cfg), to_port(params), batch_size=1, device="cpu",
                              use_native_packer=False)
    et.tokenizer = tTOK.FallbackTokenizer()
    return cfg, ej, et


def _asr_files(tmp_path, cfg):
    rng = np.random.default_rng(3)
    paths = []
    for i, secs in enumerate((1.4, 0.6)):
        p = str(tmp_path / f"f{i}.wav")
        jAU.write_wav(p, rng.standard_normal(int(cfg.mimi.sample_rate * secs)) * 0.2,
                      int(cfg.mimi.sample_rate))
        paths.append(p)
    return paths


def _same_transcript(got, want):
    assert got["words"] == want["words"] and got["text"] == want["text"]
    if "vad" in want:
        assert [v["step_idx"] for v in got["vad"]] == [v["step_idx"] for v in want["vad"]]
        np.testing.assert_allclose([v["prs"] for v in got["vad"]],
                                   [v["prs"] for v in want["vad"]], atol=1e-5, rtol=0)


@pytest.mark.parametrize("sampled", [False, True])
def test_transcribe_files_matches_jax(tmp_path, asr_pair, sampled):
    cfg, ej, et = asr_pair[sampled]
    paths = _asr_files(tmp_path, cfg)
    want = joffline.transcribe_files(paths, vad=True, engine=ej)
    got = toffline.transcribe_files(paths, vad=True, engine=et)
    assert len(got) == 2
    if sampled:  # greedy tokens of random weights settle on one id: no word ends
        assert sum(len(r["words"]) for r in got) >= 2
    for g, w in zip(got, want):
        _same_transcript(g, w)
    frames = [len(jAU.decode_audio(p, int(cfg.mimi.sample_rate))) // cfg.mimi.frame_size
              + cfg.asr_delay_in_tokens + 8 for p in paths]
    assert [len(r["vad"]) for r in got] == frames
    for p, g in zip(paths, got):  # one at a time, batched and frame by frame
        _same_transcript(toffline.transcribe_file(p, vad=True, engine=et), g)
        _same_transcript(toffline.transcribe_per_frame(p, et, vad=True), g)
        _same_transcript(g, joffline.transcribe_file(p, vad=True, engine=ej))
    assert "vad" not in toffline.transcribe_file(paths[0], engine=et)


def test_transcribe_file_of_the_mp3_sample_matches_jax(asr_pair):
    if not tcodecs.mp3_available():
        pytest.skip("libmpg123 unavailable (as tests/test_offline_cli.py)")
    _cfg, ej, et = asr_pair[0]
    path = os.path.join(ROOT, "audio", "speech-synthetic.mp3")
    _same_transcript(toffline.transcribe_file(path, engine=et),
                     joffline.transcribe_file(path, engine=ej))


# ---------------------------------------------------------------------------
# Offline TTS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tts_params():
    jcfg = small_tts_cfg(max_steps=96, text_temperature=0.6, temperature=0.8)
    mcfg = small_mimi_cfg()
    return jcfg, mcfg, {"lm": np_lm_params(jcfg.lm, 4)}, np_mimi_params(mcfg, 5)


def _tts_single(tts_params):
    jcfg, mcfg, params, mp = tts_params
    ej = JaxTts(jcfg, params, mcfg, mp, jTOK.SentencePieceModel.from_bytes(spm_bytes()))
    et = tTM.TtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mcfg), to_port(mp),
                       tTOK.SentencePieceModel.from_bytes(spm_bytes()), device="cpu")
    return ej, et


def _tts_batched(tts_params):
    jcfg, mcfg, params, mp = tts_params
    ej = JaxBatchedTts(jcfg, params, mcfg, mp, jTOK.SentencePieceModel.from_bytes(spm_bytes()),
                       batch_size=2, ca_len=6)
    et = tTB.BatchedTtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mcfg),
                              to_port(mp), tTOK.SentencePieceModel.from_bytes(spm_bytes()),
                              batch_size=2, ca_len=6, device="cpu")
    return ej, et


def _same_wav(got, want):
    a, sr_a = tAU.read_wav(got)
    b, sr_b = tAU.read_wav(want)
    assert sr_a == sr_b == 24_000 and a.shape == b.shape and a.size > 0
    assert np.abs(np.round(a * 32768) - np.round(b * 32768)).max() <= WAV_LSB


def test_synthesize_file_matches_jax(tmp_path, tts_params, monkeypatch):
    ej, et = _tts_single(tts_params)
    monkeypatch.setattr(joffline, "_build_tts_engine", lambda config_path: ej)
    text = "fab ked gic hai"
    want = joffline.synthesize_file(text, str(tmp_path / "j.wav"))
    got = toffline.synthesize_file(text, str(tmp_path / "t.wav"), engine=et)
    assert got["transcript"] == want["transcript"] and len(got["transcript"]) == 4
    assert got["duration_s"] == want["duration_s"] > 0
    _same_wav(got["out"], want["out"])


@pytest.mark.parametrize("batched", [False, True])
def test_synthesize_jsonl_matches_jax(tmp_path, tts_params, batched):
    ej, et = (_tts_batched if batched else _tts_single)(tts_params)
    src = tmp_path / "in.jsonl"
    src.write_text("".join(json.dumps(item) + "\n" for item in (
        {"id": "a", "turns": ["fab ked"], "voices": ["default"]},
        {"id": "b", "turns": ["gic", "hai fab"], "voices": []},
        {"id": "c", "turns": ["ked ked"]})))
    want = joffline.synthesize_jsonl(str(src), str(tmp_path / "j"), engine=ej)
    got = toffline.synthesize_jsonl(str(src), str(tmp_path / "t"), engine=et)
    if batched:  # the JAX loop's last tick may outlive its stop(): end it here
        ej.thread.join()
        assert not et.thread.is_alive()
    assert [m["id"] for m in got] == ["a", "b", "c"]
    for g, w in zip(got, want):
        assert (g["id"], g["duration_s"], g["words"]) == (w["id"], w["duration_s"], w["words"])
        assert g["words"] >= 1
        _same_wav(g["out"], w["out"])
    if batched:
        assert not et.running and et.used_slots() == 0


# ---------------------------------------------------------------------------
# cli stt and cli tts
# ---------------------------------------------------------------------------


def test_cli_stt_and_tts_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    raw, _ = _small_module("asr", 1)
    stt_toml = tmp_path / "stt.toml"
    stt_toml.write_text(_dump(raw))
    sr = int(small_mimi_cfg().sample_rate)
    paths = []
    for i, secs in enumerate((1.0, 0.5)):
        paths.append(str(tmp_path / f"a{i}.wav"))
        tAU.write_wav(paths[-1], np.random.default_rng(i).standard_normal(int(sr * secs)) * 0.2,
                      sr)
    assert tcli.main(["stt", *paths, "--config", str(stt_toml), "--device", "cpu", "--json",
                      "--vad"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = toffline.transcribe_files(paths, config_path=str(stt_toml), vad=True, device="cpu")
    assert printed == [{"path": p, **r} for p, r in zip(paths, want)]
    assert tcli.main(["stt", paths[0], "--config", str(stt_toml), "--device", "cpu"]) == 0
    lines = [f"[{w['start_s']:7.2f}s] {w['text']}" for w in want[0]["words"]]
    assert capsys.readouterr().out == "\n".join(lines + [want[0]["text"]]) + "\n"

    raw, _ = _small_module("tts", 1)
    tts_toml = tmp_path / "tts.toml"
    tts_toml.write_text(_dump(raw))
    out = tmp_path / "o.wav"
    assert tcli.main(["tts", "hello there", str(out), "--config", str(tts_toml),
                      "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["out"] == str(out) and printed["duration_s"] == round(
        len(tAU.read_wav(str(out))[0]) / 24_000.0, 3) > 0
    assert [w["text"] for w in printed["transcript"]] == ["hello", "there"]
    jl = tmp_path / "in.jsonl"
    jl.write_text(json.dumps({"id": "x", "turns": ["hi"], "voices": []}) + "\n")
    assert tcli.main(["tts", str(jl), str(tmp_path / "outs"), "--jsonl", "--config",
                      str(tts_toml), "--device", "cpu"]) == 0
    manifest = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [m["id"] for m in manifest] == ["x"] and os.path.exists(manifest[0]["out"])


def test_default_modules_resolve_to_random_weights_without_downloads():
    """The defaults (stt-1b, and configs/config-tts.toml's tts-1.6b) name
    ``hf://`` files, which resolve to absent."""
    asr = toffline._default_asr_module()
    tts = Config.load(toffline.DEFAULT_TTS_CONFIG).modules["tts"]
    assert asr.lm.d_model == 2048 and tts.lm.depformer.num_slices == 32
    from dsm_tpu_torch.server.config import resolve_path

    for mod in (asr, tts):
        assert all(resolve_path(f) is None for f in (
            mod.lm_model_file, mod.text_tokenizer_file, mod.audio_tokenizer_file))
    assert resolve_path(tts.voice_dir) is None and tts.type == "Tts"
    assert asr.raw == {} and asr.batch_size == 1
