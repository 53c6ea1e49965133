"""The port's single-session TTS (``server/tts_module.py``: ``TtsEngine``,
``TtsSession``), its builder from a TOML with local checkpoint files, and
its App routes against the JAX package, at small sizes on the CPU.

Bars:

* ``synthesize`` and a word-fed ``TtsSession`` (seeded sampling at
  temperature > 0, with and without a voice, with a condition): the same
  words with the same timestamps and the same number of frames, token for
  token; the pcm within atol 1e-4 (the port decodes every tick with a mask,
  as its captured tick must, so the codec's ring positions run ahead of the
  JAX session's, whose decode starts at the first frame: the same relative
  attention, rounded otherwise);
* the builders from a TOML whose ``lm_model_file`` and
  ``audio_tokenizer_file`` name local reference-layout files (safetensors
  f32 or bf16, and GGUF Q8_0): the LM and codec trees equal the JAX
  builder's through ``bridge.from_numpy_tree`` bit for bit, for
  ``build_batched_asr``, ``build_tts`` at ``batch_size`` 1 and 2 and
  ``build_duplex``; the adopted conditioner weights exactly and in the
  file's dtype, the default condition within 1e-6 (1e-2 from a bf16 file,
  where both sides compute it in bf16);
* the App's single-session WebSocket and POST routes: the JAX App's
  messages in the same order (words equal, audio within 1e-4), the same
  close code and error for an unknown voice.
"""

import asyncio
import threading
import time
import tomllib

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from safetensors.numpy import save_file

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server import builder as jbuilder
from dsm_tpu.server import config as jCFG
from dsm_tpu.server.app import App as JaxApp
from dsm_tpu.server.tts_module import TtsEngine as JaxEngine
from dsm_tpu.server.tts_module import TtsSession as JaxSession
from dsm_tpu.utils import checkpoint as jCK
from dsm_tpu.utils import gguf as jG
from dsm_tpu.utils import tokenizer as jTOK
from dsm_tpu_torch import bridge
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server import tts_module as tTM
from dsm_tpu_torch.server.app import App
from dsm_tpu_torch.utils import tokenizer as tTOK
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_checkpoint import assert_same_tree
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_mimi_cfg
from tests.test_torch_tts_serving import port_tts_cfg, spm_bytes
from tests.test_tts import small_tts_cfg

torch.set_num_threads(2)
PCM_ATOL = 1e-4


def _engines(condition=False, **cfg_kw):
    # A voice of 6 frames: one speaker of 0.5 s at 12.5 Hz.
    jcfg = small_tts_cfg(max_steps=96, text_temperature=0.6, temperature=0.8,
                         speaker_cond_n_speakers=1, speaker_cond_duration_s=0.5, **cfg_kw)
    mcfg = small_mimi_cfg()
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(0))}
    mp = jMIMI.init(mcfg, jax.random.PRNGKey(1))
    ej = JaxEngine(jcfg, params, mcfg, mp, jTOK.SentencePieceModel.from_bytes(spm_bytes()))
    et = tTM.TtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mcfg), to_port(mp),
                       tTOK.SentencePieceModel.from_bytes(spm_bytes()), device="cpu")
    if condition:
        cond = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (1, 32))) * 0.5
        ej.default_condition, et.default_condition = jnp.asarray(cond), torch.from_numpy(cond)
    return jcfg, params, ej, et


def _voice(jcfg, params, seed):
    ca = jax.random.normal(jax.random.PRNGKey(seed), (1, 6, 16))
    kv = jT.precompute_ca_kv(jcfg.lm.transformer, params["lm"]["transformer"], ca)
    return kv, tuple(torch.from_numpy(np.array(x)) for x in kv)


def _same_audio(pt, pj):
    assert pt.shape == pj.shape and pt.size > 0 and pt.dtype == np.float32
    np.testing.assert_allclose(pt, pj, atol=PCM_ATOL, rtol=0)


@pytest.mark.parametrize("voice,seed,cond", [(False, 3, False), (True, 5, False),
                                             (True, 11, True), (False, 0, True)])
def test_synthesize_matches_jax(voice, seed, cond):
    jcfg, params, ej, et = _engines(condition=cond)
    kj, kt = _voice(jcfg, params, 2) if voice else (None, None)
    text = "fab ked gic hai"
    pj, wj = ej.synthesize(text, ca_kv=kj, seed=seed,
                           condition=ej.default_condition)
    pt, wt = et.synthesize(text, ca_kv=kt, seed=seed, condition=et.default_condition)
    assert [(w.text, w.start_s, w.stop_s) for w in wt] == \
        [(w.text, w.start_s, w.stop_s) for w in wj]
    assert [w.text for w in wt] == text.split()
    _same_audio(pt, pj)
    # A second session starts from a fresh state: the same output again.
    pt2, wt2 = et.synthesize(text, ca_kv=kt, seed=seed, condition=et.default_condition)
    assert [vars(w) for w in wt2] == [vars(w) for w in wt]
    np.testing.assert_array_equal(pt2, pt)


def _feed_slowly(session, words):
    def run():
        for w in words:
            time.sleep(0.01)
            session.feed_words([w])
        session.end_input()

    t = threading.Thread(target=run)
    t.start()
    return t


def test_session_fed_word_by_word_matches_jax():
    jcfg, params, ej, et = _engines()
    kj, kt = _voice(jcfg, params, 4)
    words, _ = et.encode_words("abc fed gab c k", inserted_bos=False)
    assert words == ej.encode_words("abc fed gab c k", inserted_bos=False)[0]
    events = {}
    for name, eng, cls, kv in (("jax", ej, JaxSession, kj), ("port", et, tTM.TtsSession, kt)):
        sess = cls(eng, ca_kv=kv, seed=21)
        evs = []
        feeder = _feed_slowly(sess, words)
        with eng.lock:
            sess.run(evs.append, word_timeout=30)
        feeder.join()
        assert sess.done
        events[name] = evs
    kinds = [[type(e).__name__ for e in events[k]] for k in ("jax", "port")]
    assert kinds[0] == kinds[1] and "WordEvent" in kinds[0] and "AudioEvent" in kinds[0]
    for a, b in zip(events["port"], events["jax"]):
        if type(b).__name__ == "WordEvent":
            assert (a.text, a.start_s, a.stop_s) == (b.text, b.start_s, b.stop_s)
        else:
            assert a.pcm.shape == (48,)
            np.testing.assert_allclose(a.pcm, b.pcm, atol=PCM_ATOL, rtol=0)


def test_cpu_engine_refuses_the_cuda_graph():
    jcfg, params, _ej, _et = _engines()
    mcfg = small_mimi_cfg()
    with pytest.raises(ValueError, match="cuda_graph"):
        tTM.TtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mcfg),
                      to_port(jMIMI.init(mcfg, jax.random.PRNGKey(1))),
                      tTOK.FallbackTokenizer(), device="cpu", cuda_graph=True)


def test_int8_voice_store_on_the_cpu():
    """``ca_quant``: the voice goes through the int8 store (the card's
    profile; on the CPU the plain version of ``ca_decode_attend``): words
    and frames as the bf16-free f32 store gives them here."""
    jcfg, params, _ej, et = _engines()
    mcfg = small_mimi_cfg()
    eq = tTM.TtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mcfg),
                       to_port(jMIMI.init(mcfg, jax.random.PRNGKey(1))),
                       tTOK.SentencePieceModel.from_bytes(spm_bytes()), device="cpu",
                       ca_quant=True)
    _kj, kt = _voice(jcfg, params, 2)
    assert et.ca_len == eq.ca_len == 6  # n_speakers x duration x frame rate
    assert eq._ca["k"].dtype == torch.int8 and eq._ca["k"].shape[3] == 128
    pq, wq = eq.synthesize("fab ked", ca_kv=kt, seed=3)
    assert [w.text for w in wq] == ["fab", "ked"] and np.isfinite(pq).all()
    et.voices = eq.voices = type("R", (), {"resolve": staticmethod(
        lambda spec: np.ones((1, 6, 16), np.float32))})()
    assert isinstance(eq.voice_kv("x"), dict) and isinstance(et.voice_kv("x"), tuple)


# ---------------------------------------------------------------------------
# Builders from a TOML with local reference-layout files
# ---------------------------------------------------------------------------

TTS_TOML = "configs/config-tts-streaming.toml"


def _small_module(kind, batch):
    """A shipped TOML at a few layers and narrow widths (same keys)."""
    path = {"asr": "configs/config-smoke.toml", "tts": TTS_TOML,
            "duplex": "configs/config-duplex-tpu-serving.toml"}[kind]
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    name = next(iter(raw["modules"]))
    mod = raw["modules"][name]
    mod["batch_size"] = batch
    model = mod["model"]
    if kind == "asr":
        model["transformer"].update(d_model=64, num_layers=2, dim_feedforward=128)
        model.update(text_in_vocab_size=65, text_out_vocab_size=64)
    if kind == "tts":  # a text vocabulary that the byte-level fallback tokenizer fits
        model.update(audio_codebooks=8, text_in_vocab_size=301, text_out_vocab_size=300)
        model["transformer"].update(d_model=64, num_heads=4, num_layers=2,
                                    dim_feedforward=128, context=64)
        model["depformer"].update(num_slices=8, low_rank_embeddings=8)
        model["depformer"]["transformer"].update(d_model=32, num_heads=2, num_layers=2,
                                                 dim_feedforward=64, context=8)
        model["conditioners"]["description"]["dim"] = 16
        mod["generation"].update(speaker_cond_dim=64, speaker_cond_n_speakers=1,
                                 text_audio_delay_in_tokens=3, text_start_token=300)
    if kind == "duplex":
        mod.update(pipeline_depth=1, kv_quant=False)
        model.update(audio_codebooks=8, text_in_vocab_size=65, text_out_vocab_size=64)
        model["transformer"].update(d_model=64, num_heads=4, num_layers=2,
                                    dim_feedforward=128, context=40)
        model["depformer"].update(num_slices=4)
        model["depformer"]["transformer"].update(d_model=32, num_heads=2, num_layers=2,
                                                 dim_feedforward=64, context=4)
        mod["generation"].update(generated_audio_codebooks=4, input_audio_codebooks=4)
    return raw, name


def _small_v0_1(port: bool):
    def v0_1(n_q=None):
        m = small_mimi_cfg()
        m = m.__class__(**{**m.__dict__, "n_q": n_q or 16})
        return port_mimi_cfg(m) if port else m
    return v0_1


def _write(path, ref, fmt):
    if fmt == "gguf":
        jG.write_gguf(path, ref, quantize=True)
    elif fmt == "bf16":
        save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in ref.items()}, path)
    else:
        save_file(ref, path)


def _np(tree):
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("kind,batch,fmt", [
    ("asr", 2, "f32"), ("asr", 2, "gguf"), ("tts", 1, "f32"), ("tts", 1, "bf16"),
    ("tts", 2, "f32"), ("duplex", 2, "f32"), ("duplex", 1, "bf16")])
def test_built_engine_from_local_files_equals_the_jax_builder(tmp_path, monkeypatch, kind,
                                                              batch, fmt):
    monkeypatch.setattr(jbuilder.MIMI, "v0_1", _small_v0_1(False))
    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    raw, name = _small_module(kind, batch)
    jmod = jCFG.Config.from_dict(raw).modules[name]
    lm_cfg = jmod.lm
    rng = np.random.default_rng(1)
    ref = {k: np.asarray(v) for k, v in jCK.lm_params_to_reference(
        lm_cfg, jLM.init(lm_cfg, jax.random.PRNGKey(2))).items()}
    if kind == "tts":
        pre = "condition_provider.conditioners.description"
        ref[f"{pre}.embed.weight"] = rng.standard_normal((5, 16)).astype(np.float32)
        ref[f"{pre}.output_proj.weight"] = rng.standard_normal((64, 16)).astype(np.float32)
    n_q = {"asr": lm_cfg.audio_codebooks, "tts": lm_cfg.generated_codebooks,
           "duplex": 4}[kind]
    mimi_cfg = jbuilder.MIMI.v0_1(n_q)
    mref = {k: np.asarray(v) for k, v in jCK.mimi_params_to_reference(
        mimi_cfg, jMIMI.init(mimi_cfg, jax.random.PRNGKey(3))).items()}
    ext = "gguf" if fmt == "gguf" else "safetensors"
    _write(str(tmp_path / f"lm.{ext}"), ref, fmt)
    _write(str(tmp_path / f"mimi.{ext}"), mref, fmt)
    raw["modules"][name].update(lm_model_file=str(tmp_path / f"lm.{ext}"),
                                audio_tokenizer_file=str(tmp_path / f"mimi.{ext}"))
    jmod = jCFG.Config.from_dict(raw).modules[name]
    tmod = tCFG.Config.from_dict(raw).modules[name]
    build = {"asr": (jbuilder.build_batched_asr, tbuilder.build_batched_asr),
             "tts": (jbuilder.build_tts, tbuilder.build_tts),
             "duplex": (jbuilder.build_duplex, tbuilder.build_duplex)}[kind]
    ej = build[0](jmod)
    et = build[1](tmod, "cpu")
    want_types = {("tts", 1): tTM.TtsEngine, ("duplex", 1): tbuilder.DuplexEngine}
    assert type(et).__name__ == type(ej).__name__
    if (kind, batch) in want_types:
        assert isinstance(et, want_types[kind, batch])
    assert_same_tree(et.params["lm"], _np(ej.params["lm"]))
    jm = ej.params["mimi"] if kind == "asr" else ej.mimi_params
    tm = et.params["mimi"] if kind == "asr" else et.mimi_params
    assert_same_tree(tm, _np(jm))
    if kind == "tts":
        pj, pt = ej.condition_provider, et.condition_provider
        for key in ("embed", "output_proj"):  # adopted; the padding stays random
            got, want = pt.params["description"][key], pj.params["description"][key]
            assert str(got.dtype).split(".")[1] == str(want.dtype)  # the file's dtype
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        # A bf16 file gives a bf16 condition on both sides, whose dot products
        # round apart by a bf16 ulp or so.
        tol = 1e-6 if fmt == "f32" else 1e-2
        np.testing.assert_allclose(et.default_condition.float().numpy(),
                                   np.asarray(ej.default_condition, np.float32),
                                   atol=tol, rtol=tol)
        assert et.voices.speaker_cfg.cond_dim == 64


def test_build_tts_single_serves_a_wav_voice(tmp_path, monkeypatch):
    """configs/config-tts.toml's keys at small widths, ``batch_size`` 1 (no
    key), a voice directory of ``.wav`` samples: ``build_tts`` gives the
    single-session engine, whose voice comes through the speaker encoder."""
    from dsm_tpu_torch.utils.audio import wav_bytes

    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    raw, name = _small_module("tts", 1)
    del raw["modules"][name]["batch_size"]
    del raw["modules"][name]["model"]["conditioners"]
    (tmp_path / "voices").mkdir()
    pcm = np.random.default_rng(0).standard_normal(1200).astype(np.float32) * 0.1
    (tmp_path / "voices" / "ex01.wav").write_bytes(wav_bytes(pcm, 600))
    raw["modules"][name]["voice_dir"] = str(tmp_path / "voices")
    eng = tbuilder.build_tts(tCFG.Config.from_dict(raw).modules[name], "cpu")
    assert isinstance(eng, tTM.TtsEngine) and not eng.cuda_graph and not eng.ca_quant
    assert eng.default_condition is None
    kv = eng.voice_kv("ex01+0.5")
    assert kv[0].shape == (2, 1, 4, 125, 16)
    pcm_out, words = eng.synthesize("hello there", ca_kv=kv, seed=1)
    assert [w.text for w in words] == ["hello", "there"] and np.isfinite(pcm_out).all()


# ---------------------------------------------------------------------------
# App routes
# ---------------------------------------------------------------------------


async def _ws_session(client, text, query=""):
    ws = await client.ws_connect("/api/tts_streaming" + query)
    msgs = []
    await ws.send_str(text)
    await ws.send_bytes(b"\0")
    async with asyncio.timeout(120):
        while True:
            msg = await ws.receive()
            if msg.type.name in ("CLOSE", "CLOSED", "ERROR"):
                break
            msgs.append(msgpack.unpackb(msg.data, raw=False))
    return msgs, ws.close_code


def _same_messages(got, want):
    assert [m["type"] for m in got] == [m["type"] for m in want]
    for a, b in zip(got, want):
        if a["type"] == "Audio":
            np.testing.assert_allclose(a["pcm"], b["pcm"], atol=PCM_ATOL, rtol=0)
        else:
            assert a == b


def test_app_single_session_routes_match_jax():
    jcfg, params, ej, et = _engines()
    from dsm_tpu.server.voices import VoiceResolver as JaxResolver
    from dsm_tpu_torch.server.voices import VoiceResolver

    ej.voices, et.voices = JaxResolver(), VoiceResolver()
    out = {}
    for side, app in (("jax", JaxApp(tts_engine=ej)), ("port", App(tts_engine=et))):
        async def main():
            async with TestClient(TestServer(app.web_app)) as client:
                ws = await _ws_session(client, "fab ked")
                bad = await _ws_session(client, "ab", "?voice=nobody")
                r = await client.post("/api/tts", json={"text": "ka bd", "seed": 5},
                                      headers={"accept": "application/json"})
                body = await r.json()
                r = await client.post("/api/tts", json={"text": "k", "voice": "nobody"})
                missing = (r.status, await r.json())
                st = await (await client.get("/api/status")).json()
                return ws, bad, body, missing, st
        out[side] = asyncio.run(main())
    (wsj, badj, bodyj, missj, stj), (wst, badt, bodyt, misst, stt) = out["jax"], out["port"]
    _same_messages(wst[0], wsj[0])
    assert wst[0][0] == {"type": "Ready"} and wst[1] == wsj[1]
    assert [m["text"] for m in wst[0] if m["type"] == "Text"] == ["fab", "ked"]
    assert badt == badj and badt[1] == 4005  # RESOURCE_UNAVAILABLE after the error message
    assert badt[0][-1]["type"] == "Error"
    assert bodyt["transcript"] == bodyj["transcript"]
    assert [w["text"] for w in bodyt["transcript"]] == ["ka", "bd"]
    assert misst == missj and misst[0] == 404
    assert "tts_capacity" not in stt and "tts_capacity" not in stj
