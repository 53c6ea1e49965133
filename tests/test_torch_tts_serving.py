"""The port's batched TTS serving path against the JAX package.

Inputs are made with numpy or the JAX init from a seed; weights are carried
over by the bridge.  Bars:

* the golden fixture tests/fixtures/golden_tts_small.json (made by
  tools/gen_golden.py on the JAX package): text tokens and audio frames
  token for token;
* ``BatchedTtsEngine`` against the JAX engine (f32 on the CPU, seeded
  sampling at temperature > 0): words and their timestamps equal, audio
  frames within atol 1e-4 (Mimi decode sums in other orders);
* tokenizer ids, preprocessed words, the safetensors reader and the
  description condition: equal (the condition within 1e-6);
* the port's App: ASR ``Word`` messages carry decoded text, the TTS
  WebSocket and POST routes return every word and whole frames.
"""

import asyncio
import re
import struct

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dsm_tpu.models import conditioner as jCOND
from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server import config as jCFG
from dsm_tpu.server import tts_preprocess as jPRE
from dsm_tpu.server.tts_batched import BatchedTtsEngine as JaxEngine
from dsm_tpu.sessions import tts as jTTS
from dsm_tpu.utils import tokenizer as jTOK
from dsm_tpu_torch.models import conditioner as tCOND
from dsm_tpu_torch.models import mimi as tMIMI
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.server import tts_preprocess as tPRE
from dsm_tpu_torch.server import voices as tV
from dsm_tpu_torch.server.app import App
from dsm_tpu_torch.server.tts_module import AudioEvent, TtsEngine, WordEvent
from dsm_tpu_torch.sessions import tts as tTTS
from dsm_tpu_torch.utils import tokenizer as tTOK
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import to_port
from tests.test_torch_tts import _fields, port_lm_cfg, port_mimi_cfg
from tests.test_tts import small_tts_cfg

torch.set_num_threads(2)

GOLDEN = "tests/fixtures/golden_tts_small.json"


def port_tts_cfg(j):
    return _fields(tTTS.TtsConfig, j, lm=port_lm_cfg(j.lm))


def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _piece(text, score, typ=1):
    body = b"\x0a" + _varint(len(text.encode())) + text.encode()
    body += b"\x15" + struct.pack("<f", score)
    if typ != 1:
        body += b"\x18" + _varint(typ)
    return b"\x0a" + _varint(len(body)) + body


def spm_bytes(n_letters=11):
    """A SentencePiece model of 16 pieces: 4 control pieces, the word
    boundary and the letters a.. (k at the default size)."""
    pieces = (_piece("<unk>", 0.0, typ=2) + _piece("<s>", 0.0, typ=3)
              + _piece("</s>", 0.0, typ=3) + _piece("<pad>", 0.0, typ=3)
              + _piece("▁", -2.0))
    for i in range(n_letters):
        pieces += _piece(chr(ord("a") + i), -1.0 - 0.1 * i)
    return pieces


# ---------------------------------------------------------------------------
# Tokenizer, preprocessing, voices, conditioner
# ---------------------------------------------------------------------------


def test_tokenizer_ids_match_jax(tmp_path):
    data = spm_bytes()
    path = tmp_path / "tok.model"
    path.write_bytes(data)
    mj = jTOK.load_tokenizer(str(path))
    mt = tTOK.load_tokenizer(str(path))
    assert isinstance(mt, tTOK.SentencePieceModel) and mt.vocab_size() == 16
    for text in ("abc", "a bcd efg", "jk ab", "ghij", "dab cab", "xyz"):
        ids = mt.encode(text)
        assert ids == mj.encode(text)
        assert mt.decode(ids) == mj.decode(ids)
    # The model tests/test_offline_cli.py builds from bytes.
    from tests.test_offline_cli import _piece as cli_piece

    data = b"".join(cli_piece(*p) for p in (
        ("<unk>", 0.0, 2), ("▁", -3.0), ("▁he", -1.0), ("llo", -1.2), ("▁hello", -1.5),
        ("l", -4.0), ("o", -4.0), ("he", -2.0)))
    mj, mt = jTOK.SentencePieceModel.from_bytes(data), tTOK.SentencePieceModel.from_bytes(data)
    for text in ("hello", "hellollo", "he llo hello", "ollehh"):
        assert mt.encode(text) == mj.encode(text)
        assert mt.decode(mt.encode(text)) == mj.decode(mj.encode(text))
    fj, ft = jTOK.FallbackTokenizer(), tTOK.load_tokenizer(None)
    assert ft.encode("héllo") == fj.encode("héllo")
    assert ft.decode(ft.encode("héllo")) == "héllo"


def test_tts_preprocess_matches_jax():
    tok_j, tok_t = jTOK.FallbackTokenizer(), tTOK.FallbackTokenizer()
    pj, pt = jPRE.Preprocessor(tok_j, 1), tPRE.Preprocessor(tok_t, 1)
    for q in ("Hello   world!", "Wait <break time=\"1.5s\"/> then go.",
              "« Ça va ? » dit-il…", ""):
        assert tPRE.normalize(q) == jPRE.normalize(q)
        assert [vars(w) for w in pt.preprocess(q)] == [vars(w) for w in pj.preprocess(q)]


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    tensors = {
        "speaker_wavs": rng.standard_normal((1, 10, 8)).astype(np.float32),
        "h": rng.standard_normal((3, 4)).astype(np.float16),
        "i": rng.integers(-100, 100, (5,)).astype(np.int8),
        "l": rng.integers(-2**40, 2**40, (2, 2)).astype(np.int64),
    }
    path = str(tmp_path / "v.safetensors")
    save_file(tensors, path, metadata={"who": "test"})
    got = tV.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    np.testing.assert_array_equal(tV.load_voice_embedding(path),
                                  tensors["speaker_wavs"])
    # bf16, written by hand: widened to f32 exactly.
    x = rng.standard_normal((2, 3)).astype(np.float32)
    bits = (x.view(np.uint32) >> 16).astype("<u2")
    header = b'{"ca_src":{"dtype":"BF16","shape":[2,3],"data_offsets":[0,12]}}'
    bpath = tmp_path / "b.safetensors"
    bpath.write_bytes(struct.pack("<Q", len(header)) + header + bits.tobytes())
    got = tV.load_voice_embedding(str(bpath))
    assert got.shape == (1, 2, 3)
    np.testing.assert_array_equal(got[0], (bits.astype(np.uint32) << 16).view(np.float32))


def test_voice_resolver(tmp_path):
    from safetensors.numpy import save_file

    emb = np.random.default_rng(1).standard_normal((1, 6, 16)).astype(np.float32)
    (tmp_path / "voices" / "sub").mkdir(parents=True)
    save_file({"speaker_wavs": emb}, str(tmp_path / "voices" / "sub" / "anna.safetensors"))
    from dsm_tpu_torch.models import speaker as tSPK
    from dsm_tpu_torch.utils.audio import wav_bytes

    mimi_cfg = port_mimi_cfg(small_mimi_cfg())  # 600 Hz audio
    pcm = np.random.default_rng(2).standard_normal(1200).astype(np.float32) * 0.1
    (tmp_path / "voices" / "bob.wav").write_bytes(wav_bytes(pcm, 600))
    spk_cfg = tSPK.SpeakerEncoderConfig(cond_dim=16, n_speakers=2, duration_s=0.96,
                                        mimi=mimi_cfg)
    gen = torch.Generator()
    arr = emb[0] * 2
    r = tV.VoiceResolver(voice_dir=str(tmp_path / "voices"), preloaded={"arr": arr},
                         speaker_cfg=spk_cfg, speaker_params=tSPK.init(spk_cfg, gen),
                         mimi_params=tMIMI.init(mimi_cfg, gen))
    np.testing.assert_array_equal(r.resolve("sub/anna"), emb)
    np.testing.assert_array_equal(r.resolve("sub/anna+2.5"), emb)
    np.testing.assert_array_equal(r.resolve("arr"), arr[None])
    assert r.resolve("") is None and r.resolve(None) is None
    save_file({"speaker_wavs": emb}, str(tmp_path / "secret.safetensors"))
    with pytest.raises(FileNotFoundError):
        r.resolve("../secret")
    with pytest.raises(FileNotFoundError):
        r.resolve("nobody")
    # A .wav sample goes through the speaker encoder (tests/test_torch_speaker.py
    # holds it to the JAX encoder): 2 speaker slots of 12 frames, cond_dim wide.
    bob = r.resolve("bob+0.5")
    assert bob.shape == (1, 24, 16) and bob.dtype == np.float32 and np.isfinite(bob).all()
    assert r.resolve("bob+0.5") is bob


def test_description_condition_matches_jax():
    raw = jCFG.Config.load("configs/config-tts-tpu-serving.toml").modules["tts"].raw
    craw = raw["model"]["conditioners"]
    pj = jCOND.ConditionProvider(64, jCOND.configs_from_toml(craw), jax.random.PRNGKey(3))
    pt = tCOND.ConditionProvider(64, tCOND.configs_from_toml(craw), torch.Generator())
    pt.params = to_port(jax.tree_util.tree_map(np.asarray, pj.params))
    for v in ("very_bad", "neutral", "very_good"):
        cj = np.asarray(pj.condition_lut("description", v))
        ct = pt.condition_lut("description", v).numpy()
        assert ct.shape == cj.shape == (1, 64)
        np.testing.assert_allclose(ct, cj, atol=1e-6, rtol=1e-6)
    with pytest.raises(KeyError):
        pt.condition_lut("description", "great")


# ---------------------------------------------------------------------------
# Config and builder
# ---------------------------------------------------------------------------


def test_serving_toml_lm_config_matches_jax():
    mj = jCFG.Config.load("configs/config-tts-tpu-serving.toml").modules["tts"]
    mt = tCFG.Config.load("configs/config-tts-tpu-serving.toml").modules["tts"]
    assert mt.type == "Tts" and mt.batch_size == 64 and mt.raw["ca_int8"]
    assert mt.lm == port_lm_cfg(mj.lm)
    # The TOML's DepFormer heads (16), not the JAX preset's 11.
    assert mt.lm.depformer.transformer.num_heads == 16
    assert mt.lm.transformer.cross_attention and mt.lm.transformer.ca_norm == "layer_norm"


def _small_tts_module(**over):
    """The serving TOML at a few layers and narrow widths (same keys)."""
    import tomllib

    with open("configs/config-tts-tpu-serving.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["tts"]
    mod.update(batch_size=2, fuse_ticks=1, pipeline_depth=1)
    mod.update(over)
    mod["model"]["transformer"].update(d_model=64, num_heads=8, num_layers=2,
                                       dim_feedforward=128, context=64)
    mod["model"]["depformer"].update(num_slices=8)
    mod["model"]["depformer"]["transformer"].update(d_model=32, num_heads=2, num_layers=2,
                                                    dim_feedforward=64, context=8)
    mod["model"].update(audio_codebooks=8)
    mod["generation"].update(speaker_cond_dim=16, speaker_cond_n_speakers=1,
                             text_audio_delay_in_tokens=3)
    return tCFG.Config.from_dict(raw).modules["tts"]


def test_quantize_weights_of_the_tts_lm_match_jax():
    """The DepFormer's leaves are stacked (slices, layers) in the JAX tree:
    their size counts once per slice and layer for the threshold, as the
    port's per-slice lists of per-layer dicts count them."""
    lm = small_tts_cfg().lm
    pj = jLM.init(lm, jax.random.PRNGKey(6))
    qj = jT.quantize_weights(pj, min_size=4096)
    qt = tT.quantize_weights(to_port(pj), min_size=4096)
    # 48 x 16 per layer: quantised only through its 4 x 2 stacked copies.
    assert isinstance(qt["depformer"]["transformer"][3][1]["in_proj_w"], dict)
    assert isinstance(qt["transformer"][1]["in_proj_w"], dict)
    assert not isinstance(qt["depformer"]["text_emb"], dict)
    want = to_port(jax.tree_util.tree_map(np.asarray, qj))
    flat_t, flat_w = (jax.tree_util.tree_leaves(x) for x in (qt, want))
    assert len(flat_t) == len(flat_w)
    for a, b in zip(flat_t, flat_w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("key,value,match", [
    ("fuse_ticks", 4, None),
    ("pipeline_depth", 2, None),
    ("mesh", {"dp": 2}, None),
    ("mesh", "cuda", "devices, have"),
    ("batch_size", 1, "single-session"),
])
def test_builder_refuses_unported_options(key, value, match):
    """``fuse_ticks``, ``pipeline_depth`` and ``mesh`` (ported) build the
    engine they name, as the JAX builder does: the fused path with the
    engine's default script ring, the depth (which warns without fusing),
    and the engine on a dp = 2 mesh of the CPU (on CUDA a mesh of more
    shards than cards raises); ``batch_size = 1`` gives ``build_tts``'s
    single-session engine, which ``build_batched_tts`` refuses."""
    if key == "mesh":
        if value == "cuda":
            n = torch.cuda.device_count()
            mod = _small_tts_module(batch_size=n + 2, mesh={"dp": n + 2})
            with pytest.raises(ValueError, match=match):
                tbuilder.build_mesh_from_config(mod, "cuda")
            return
        eng = tbuilder.build_batched_tts(_small_tts_module(mesh=value), "cpu")
        assert eng.mesh.shape == {"dp": 2, "tp": 1} and eng.state is None
        assert [sh.batch_size for sh, in eng.shards] == [1, 1]
        return
    mod = _small_tts_module(**{key: value})
    if key == "batch_size":  # served since the single-session engine is ported
        eng = tbuilder.build_tts(mod, "cpu")
        assert isinstance(eng, TtsEngine) and not eng.cuda_graph
        with pytest.raises(ValueError, match="single-session"):
            tbuilder.build_batched_tts(mod, "cpu")
        return
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            tbuilder.build_batched_tts(mod, "cpu")
        return
    eng = tbuilder.build_batched_tts(mod, "cpu")
    assert (eng.fuse, eng.pipeline_depth) == ((4, 1) if key == "fuse_ticks" else (1, 2))
    assert eng.script_cap == 1024
    if key == "fuse_ticks":
        assert eng._mstate["toks"].shape == (2, 1024)


def test_builder_builds_the_cpu_profile(tmp_path):
    (tmp_path / "tok.model").write_bytes(spm_bytes())
    mod = _small_tts_module(text_tokenizer_file=str(tmp_path / "tok.model"))
    eng = tbuilder.build_batched_tts(mod, "cpu")
    assert isinstance(eng.tokenizer, tTOK.SentencePieceModel)
    assert eng.batch_size == 2 and eng.ca_quant and eng.ca_len == 125
    assert eng._pcm_wire_i16 and not eng.cfg.kv_quant
    assert eng._ca["k"].shape == (2, 2, 8, 128, 8)
    assert not isinstance(eng.params["lm"]["transformer"][0]["in_proj_w"], dict)
    assert eng.default_condition.shape == (1, 64)
    assert eng.mimi_cfg.n_q == 8


# ---------------------------------------------------------------------------
# The TTS step: golden fixture
# ---------------------------------------------------------------------------


def test_golden_tts_small_reproduced_from_jax_weights():
    import json

    jcfg = small_tts_cfg(max_steps=96)
    cfg = port_tts_cfg(jcfg)
    params = {"lm": to_port(jLM.init(jcfg.lm, jax.random.PRNGKey(0)))}
    rows = 4
    state = tTTS.init_state(cfg, rows, torch.float32)
    ca_tokens = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(2), (rows, 6, 16))))
    ca_kv = tT.precompute_ca_kv(cfg.lm.transformer, params["lm"]["transformer"], ca_tokens)
    seeds = torch.tensor([11, 12, 11, 12])
    alpha = torch.tensor([1.0, 2.5])
    modes = torch.full((rows,), tTTS.ALLOW_PAD_OR_EPAD, dtype=torch.int32)
    toks = torch.zeros((rows,), dtype=torch.int32)
    text, frames = [], []
    for _ in range(24):
        out, state = tTTS.step(cfg, params, state, modes, toks, ca_kv=ca_kv,
                               seeds=seeds, cfg_alpha=alpha)
        text.append(out["text_token"].tolist())
        fv, fr = out["frame_valid"].tolist(), out["frame"].tolist()
        frames.append([fr[b] if fv[b] else None for b in range(rows)])
    with open(GOLDEN) as f:
        want = json.load(f)
    assert text == want["text_tokens"]
    assert frames == want["audio_frames"]
    assert any(f is not None for row in frames for f in row)


def test_tts_step_with_forced_words_and_resets_matches_jax():
    """Forced text, pads, per-slot resets and temperatures, and the final
    pad overwrite: equal tokens and buffers over 30 steps."""
    jcfg = small_tts_cfg(max_steps=64)
    cfg = port_tts_cfg(jcfg)
    pj = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(4))}
    pt = {"lm": to_port(pj["lm"])}
    b = 3
    sj = jTTS.init_state(jcfg, b, jnp.float32)
    st = tTTS.init_state(cfg, b, torch.float32)
    src = np.random.default_rng(5).standard_normal((b, 6, 16)).astype(np.float32)
    cj = jT.precompute_ca_kv(jcfg.lm.transformer, pj["lm"]["transformer"], jnp.asarray(src))
    ct = tT.precompute_ca_kv(cfg.lm.transformer, pt["lm"]["transformer"], torch.from_numpy(src))
    rng = np.random.default_rng(6)
    seeds = np.array([3, 4, 5], np.uint32)
    temps = {"text": np.array([0.7, 0.0, 1.1], np.float32),
             "audio": np.array([0.9, 0.5, 0.0], np.float32)}
    for i in range(30):
        modes = rng.integers(0, 3, b).astype(np.int32)
        toks = rng.integers(4, 32, b).astype(np.int32)
        mask = rng.uniform(size=b) < 0.85
        reset = np.array([i == 12, False, i == 20])
        kw_j = dict(ca_kv=cj, mask=jnp.asarray(mask), reset=jnp.asarray(reset),
                    temps={k: jnp.asarray(v) for k, v in temps.items()},
                    seeds=jnp.asarray(seeds))
        kw_t = dict(ca_kv=ct, mask=torch.from_numpy(mask), reset=torch.from_numpy(reset),
                    temps={k: torch.from_numpy(v) for k, v in temps.items()},
                    seeds=torch.from_numpy(seeds.astype(np.int64)))
        oj, sj = jTTS.step(jcfg, pj, sj, jnp.asarray(modes), jnp.asarray(toks),
                           jax.random.PRNGKey(i), **kw_j)
        ot, st = tTTS.step(cfg, pt, st, torch.from_numpy(modes), torch.from_numpy(toks),
                           **kw_t)
        for key in ("text_token", "frame", "frame_valid", "step_idx"):
            np.testing.assert_array_equal(ot[key].numpy(), np.asarray(oj[key]))
        if i % 7 == 6:
            sel = np.array([True, False, True])
            sj = jTTS.overwrite_last_text_token(sj, jcfg.text_pad_token, sel)
            st = tTTS.overwrite_last_text_token(st, cfg.text_pad_token, torch.from_numpy(sel))
    for key in ("audio_tokens", "text_tokens", "consecutive_pads", "prev_text", "step_idx"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))


def test_tokenize_prompt_matches_jax():
    tok = tTOK.FallbackTokenizer()
    turns = ["hello there friend", "yes", "and  you"]
    assert (tTTS.tokenize_prompt(turns, 1, 2, tok.encode)
            == jTTS.tokenize_prompt(turns, 1, 2, tok.encode))


# ---------------------------------------------------------------------------
# BatchedTtsEngine against the JAX engine
# ---------------------------------------------------------------------------


def _engines(batch=2, **kw):
    jcfg = small_tts_cfg(max_steps=96)
    mimi_cfg = small_mimi_cfg()
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(0))}
    mimi_params = jMIMI.init(mimi_cfg, jax.random.PRNGKey(1))
    # Letters a..k encode inside the small text vocabulary.
    ej = JaxEngine(jcfg, params, mimi_cfg, mimi_params,
                   jTOK.SentencePieceModel.from_bytes(spm_bytes()),
                   batch_size=batch, ca_len=6, **kw)
    et = tTB.BatchedTtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mimi_cfg),
                              to_port(mimi_params),
                              tTOK.SentencePieceModel.from_bytes(spm_bytes()),
                              batch_size=batch, ca_len=6, device="cpu", **kw)
    return jcfg, params, ej, et


def _voice(jcfg, params, seed):
    ca_tokens = jax.random.normal(jax.random.PRNGKey(seed), (1, 6, 16))
    return jT.precompute_ca_kv(jcfg.lm.transformer, params["lm"]["transformer"], ca_tokens)


def _drive(eng, voices, to_voice, open_kw):
    """Three sessions on two slots: the third reuses the slot of the first
    to finish.  Returns each session's events."""
    events = [[] for _ in range(3)]
    texts = ["abc fed", "gab c ef", "hak kij"]

    def open_(i):
        drv = eng.open_session(events[i].append, voice_ca=to_voice(voices[i]), **open_kw[i])
        words, _ = eng.encode_words(texts[i], inserted_bos=False)
        drv.feed_words(words)
        drv.end_input()
        return drv

    live = {0: open_(0), 1: open_(1)}
    for _ in range(400):
        if not eng.tick():
            break
        for i, drv in list(live.items()):
            if any(isinstance(e, tTB.DoneEvent) or type(e).__name__ == "DoneEvent"
                   for e in events[i]):
                eng.close_session(drv)
                del live[i]
                if 2 not in live and not events[2]:
                    live[2] = open_(2)
    for drv in live.values():
        eng.close_session(drv)
    return events


def _summary(events):
    words, frames, done = [], [], 0
    for e in events:
        name = type(e).__name__
        if name == "WordEvent":
            words.append((e.text, e.start_s, e.stop_s))
        elif name == "AudioEvent":
            frames.append(np.asarray(e.pcm, np.float32))
        elif name == "DoneEvent":
            done += 1
    return words, frames, done


@pytest.mark.parametrize("variant", ["plain", "ca_int8", "cfg"])
def test_engine_matches_jax_engine(variant):
    kw = {"ca_quant": True} if variant == "ca_int8" else {}
    if variant == "cfg":
        kw["cfg_enabled"] = True
    jcfg, params, ej, et = _engines(**kw)
    voices = [_voice(jcfg, params, 2), None, _voice(jcfg, params, 3)]
    open_kw = [dict(seed=7, text_temperature=0.8, audio_temperature=0.9),
               dict(seed=8, audio_temperature=1.0),
               dict(seed=9, text_temperature=0.0, audio_temperature=0.7)]
    if variant == "cfg":
        for k, a in zip(open_kw, (2.0, None, 1.5)):
            k["cfg_alpha"] = a
    ev_j = _drive(ej, voices, lambda v: v, open_kw)
    ev_t = _drive(et, voices, lambda v: None if v is None else
                  tuple(torch.from_numpy(np.asarray(x)) for x in v), open_kw)
    for sj, st in zip(ev_j, ev_t):
        wj, fj, dj = _summary(sj)
        wt, ft, dt = _summary(st)
        assert dj == dt == 1
        assert wt == wj and len(wt) >= 2
        assert len(ft) == len(fj) >= 1
        for a, b in zip(ft, fj):
            assert a.shape == (48,)
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert et.step_count > 0 and et.used_slots() == 0


def test_engine_int16_wire_and_quantised_voice_store():
    jcfg, params, _ej, et = _engines(ca_quant=True, pcm_wire_int16=True)
    voice = tuple(torch.from_numpy(np.asarray(x)) for x in _voice(jcfg, params, 2))
    drv = et.open_session(lambda e: None, voice_ca=voice, seed=1)
    et.tick()
    want = tT.quantize_ca_kv(voice, s_len=6)
    assert et._ca["k"].shape[3] == 128 and et._ca["s_len"] == 6
    for key in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(et._ca[key][:, drv.slot].numpy(),
                                      want[key][:, 0].numpy())
    other = 1 - drv.slot
    assert not et._ca["k"][:, other].any()
    et.close_session(drv)
    # The int16 wire: pairs of samples per 32-bit word, scaled by 32767.
    pcm = np.array([0.5, -1.0, 0.25, 1.0], np.float32)
    words = np.clip(pcm * 32767.0, -32767, 32767).astype(np.int16).view(np.int32)
    np.testing.assert_allclose(et._unpack_pcm(words, 1, 4)[0], pcm, atol=1 / 32767)
    with pytest.raises(ValueError, match="ca_len"):
        et.open_session(lambda e: None, voice_ca=tuple(x[:, :, :, :5] for x in voice))


def test_engine_synthesize_offline():
    jcfg, params, _ej, et = _engines()
    pcm, words = et.synthesize("fab ked", voice_ca=None, seed=3)
    assert [w.text for w in words] == ["fab", "ked"]
    assert pcm.ndim == 1 and pcm.size % 48 == 0 and pcm.size > 0
    assert np.isfinite(pcm).all()


# ---------------------------------------------------------------------------
# The port's App: TTS routes
# ---------------------------------------------------------------------------


def test_app_serves_tts_ws_and_post():
    _jcfg, _params, _ej, et = _engines()
    et.voices = tV.VoiceResolver()
    et.start()
    app = App(tts_engine=et)

    async def ws_client(client, text):
        ws = await client.ws_connect("/api/tts_streaming?seed=9&audio_temperature=0.8")
        assert msgpack.unpackb((await ws.receive()).data) == {"type": "Ready"}
        await ws.send_str(text)
        await ws.send_bytes(b"\0")
        words, frames = [], 0
        async with asyncio.timeout(120):
            while True:
                msg = await ws.receive()
                if msg.type.name in ("CLOSE", "CLOSED", "ERROR"):
                    break
                m = msgpack.unpackb(msg.data, raw=False)
                if m["type"] == "Text":
                    assert m["stop_s"] >= m["start_s"]
                    words.append(m["text"])
                elif m["type"] == "Audio":
                    assert len(m["pcm"]) == 48 and np.isfinite(m["pcm"]).all()
                    frames += 1
        return words, frames

    async def main():
        async with TestClient(TestServer(app.web_app)) as client:
            (w1, f1), (w2, f2) = await asyncio.gather(ws_client(client, "ab"),
                                                      ws_client(client, "cd ef"))
            assert w1 == ["ab"] and w2 == ["cd", "ef"] and f1 >= 1 and f2 >= 1
            r = await client.post("/api/tts", json={"text": "ka bd", "seed": 5},
                                  headers={"accept": "application/json"})
            body = await r.json()
            assert [w["text"] for w in body["transcript"]] == ["ka", "bd"]
            r = await client.post("/api/tts", json={"text": "k"})
            wav = await r.read()
            assert r.content_type == "audio/wav" and wav[:4] == b"RIFF"
            st = await (await client.get("/api/status")).json()
            assert st["tts_capacity"]["total"] == 2
            r = await client.post("/api/tts", json={"text": "k", "voice": "nobody"})
            assert r.status == 404

    try:
        asyncio.run(main())
    finally:
        et.stop()


def test_word_events_are_the_ports_own():
    assert WordEvent.__module__ == "dsm_tpu_torch.server.tts_module"
    assert AudioEvent.__module__ == "dsm_tpu_torch.server.tts_module"
    assert re.fullmatch(r"dsm_tpu_torch\..*", tTB.DoneEvent.__module__)


def test_rvq_decode_of_out_of_range_codes_matches_jax():
    """A masked-out frame hands the decoder pads and unwritten entries; they
    index as JAX's gather does (and never fault on the card)."""
    from dsm_tpu.ops import rvq as jQ
    from dsm_tpu_torch.ops import rvq as tQ

    jcfg = jQ.SplitRvqConfig(dim=8, input_dim=16, output_dim=16, n_q=4, bins=32)
    params = jQ.split_init(jcfg, jax.random.PRNGKey(0))
    tcfg = _fields(tQ.SplitRvqConfig, jcfg)
    codes = np.array([[[0], [31], [32], [-1]], [[5], [-1], [40], [7]]], np.int32)
    yj = jQ.split_decode(jcfg, params, jnp.asarray(codes))
    yt = tQ.split_decode(tcfg, to_port(params), torch.from_numpy(codes))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
