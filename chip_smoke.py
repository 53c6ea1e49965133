#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (dsm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout.  It needs a CUDA device and nvcc; without a
device it exits with code 2 and prints no result.  Phases, one or more
lines each:

1. card: name, power limit, TF32 switches (both off; RVQ distances in f32);
2. build: the CUDA kernels from dsm_tpu_torch/csrc, with nvcc; then
   ``[opus]``: whether libopus and libogg load on this machine (the Opus wire,
   ``dsm_tpu_torch/utils/opus.py``, is host code); where they do,
   audio/speech-synthetic.wav through the port's encoder and decoder in 80 ms
   frames, one sample out for each in and correlation above OPUS_MIN_CORR
   after aligning for the codec's delay, with the host's median ms a frame for
   each; where they do not, one line (a missing host library, not a device
   path);
3. kernels: each CUDA kernel against its plain PyTorch version at the
   shapes both serving paths give it (the STT rings, C=768; the TTS rings,
   C = window = 1024, past their wrap; the TTS voice source; the duplex
   rings, (24,20,3072,128), through the split pipeline: ring_commit_q, then
   decode_attend unsplit and at its chosen split; the duplex codec's bf16
   rings at B=24; the stt-2.6b rings, (64,32,384,64), through decode_attend
   in one span and through the fused decode_attend_commit; tts_202501's,
   (64,32,512,64), through decode_attend; the stt-1b rings,
   (64,16,768,128), through decode_attend; the weight-only matmul qmm at the
   stt-2.6b matmul shapes, M = 64, and at M = 1 and 24; quantize_commit, the
   step's quantise-and-commit, at the int8 and packed-int4 rings of stt-1b,
   stt-2.6b and s2s-2b, and quantize_scale_commit at the fused route's rings,
   each at w = 0, C/2 and C - 1 with V strided as the QKV product gives it and
   row amaxes where a reciprocal would miss the quotient; rope_commit, the
   rotary embedding folded into the bf16 commit, at the Mimi rings of the
   STT/TTS and duplex engines, and rope_qk, the rope alone, at the LM rows of
   stt-1b, stt-2.6b, s2s-2b and Moshi 7B, q, k and v strided views of a QKV
   product; Moshi 7B's rings (24,32,3072,128) through quantize_commit and
   decode_attend),
   run three times
   with identical results; the fused decode_attend_commit against its
   plain version in its own span order and within the bar of the
   whole-ring order too; commits bit-exact, attention within 2e-2 on
   inputs whose outputs are O(1), where a dropped row, a padding row read,
   the committed row let in or a wrong mask would fail the bar (checked on
   the plain version); qmm within one bf16 step (or 1e-2) of its plain
   version and 2e-3 in relative L2, where a dropped scale or a dropped piece
   of K would fail;
4. serve: the BatchedAsr engine from configs/config-stt.toml (stt-1b,
   d=2048, 16 layers, 32 codebooks, B=64, int8 KV, int8 weights + W8A8,
   bf16 codec, seeded random weights) serves 8 sessions, then 4 more in
   reused slots; every frame gets its step event, every marker arrives,
   VAD probabilities are finite, and the kernels launched exactly
   16 rope_qk + 16 quantize_scale_commit + 16 decode_attend_commit + 8
   rope_commit per step (and no scale_commit, ring_commit_q or ring_commit:
   no serving path launches them);
5. times: engine step with all 64 slots active, its kernel profile over
   the served rings and over full, wrapped rings; then ``[stt1b-split]``: the
   stt-1b LM step at 4 layers with the fused setting off (quantize_commit +
   decode_attend at the stt-1b rings) against the fused route from one
   state; then the stt-2.6b path: ``[stt26]`` the BatchedAsr engine from
   configs/config-stt-en.toml as shipped (d=2048, 48 layers, 32 heads x 64,
   context 375, B=64, int8 KV, weight-only int8 weights (w8a8 = false), no
   VAD heads) serves 8 + 4 sessions through the 32-token delay with exactly
   PER_STEP_STT26 launches per step and no int8 library GEMM,
   ``[stt26-times]``/``[stt26-profile]`` as for stt-1b, and ``[stt26-path]``:
   one LM step through the kernels against the same step through the plain
   versions, and with the fused setting on (quantize_scale_commit +
   decode_attend_commit at h=32, Dh=64) against the split route.  The
   engines of these phases run the eager step (``cuda_graph=False``), so that
   the wrappers count every launch; ``[graph-stt1b]``, ``[graph-stt26]`` and
   ``[graph-stt1b-kv4]`` run ``BatchedAsrEngine`` as it serves, its step
   captured once as a CUDA graph and replayed every tick: the captured
   engine's step timed (host ms, device busy share and device launches a
   step from a profile, peak memory with the graph's pool; the eager step's
   times are PERF.md section 5's), then the replay against the eager ``ASR.step`` from one state over GRAPH_STEPS
   steps (past a wrap of every ring; slots opened, closed and reset, partial
   masks): outputs bit for bit at every step, the whole state every 100 steps
   and at the end; at stt-1b the captured engine also serves the 12-session
   workload of ``[serve]`` beside an eager engine, events equal, its launches
   counted over its warm-up and capture (a replay counts none);
6. tts: the batched TTS engine from configs/config-tts-tpu-serving.toml
   (tts-1.6b-en_fr, d=2048, 16 layers, DepFormer 32 slices x 4 layers,
   B=64, int8 voice store, int8 KV, int8 weights + W8A8, bf16 codec, the
   description LUT, the int16 pcm wire; fuse_ticks and pipeline_depth set
   to 1: the single-tick path, eager) serves 8 sessions with seeded random
   voices and 4 without, then 4 more in reused slots (TTS_EAGER_SERVED; else
   it opens 64 sessions and runs TTS_EAGER_TICKS ticks), the kernels launched
   exactly PER_TICK_TTS per tick; then a kernel profile of
   the tick at 64 active slots, and the LM step with the voice store and
   the Mimi decode step from that state are held against the same steps
   through the kernels' plain versions (``[tts-path]``).  This engine runs
   the eager tick (``cuda_graph=False``), so that the wrappers count every
   launch; ``[graph-tts]`` (and ``[graph-tts202501]`` after ``[tts202501]``)
   runs ``BatchedTtsEngine`` as ``build_batched_tts`` makes it on CUDA, its
   tick (the TTS step, the DepFormer, the gated Mimi decode, the packing)
   captured once as a CUDA graph and replayed every tick: it serves the same
   16 sessions (every session ends, every frame is 1,920 finite samples,
   every word fed comes back), each session's events equal to the eager
   engine's (words with their times, frames bit for bit), its launches
   counted over its warm-up and capture (a replay counts none); the captured tick is timed at 64 active slots
   (host ms, device busy share, launches and kernel ms from a profile, peak
   memory with the graph's pool); then the replay is held to the eager
   ``TTS.step`` + ``MIMI.decode_step`` from one state over GRAPH_TICKS ticks
   (past a wrap of the LM ring and the Mimi decoder's ring; slots opened,
   closed and reset, partial masks, a voice written and a pad overwrite
   between replays): the packed array bit for bit at every tick, the whole
   state every 40 ticks and at the end;
7. duplex: the batched full-duplex dialogue engine from
   configs/config-duplex-tpu-serving.toml (s2s-2b: d=2560, 24 layers, 20
   heads x 128, context 3000, 16 + 16 codebooks, DepFormer 16 slices x 6
   layers, B=24, int8 KV, int8 weights + W8A8, bf16 codec), eager
   (``cuda_graph=False``, so that the wrappers count every launch) at
   pipeline_depth 1 (the file's 2 -> 1: the reference of ``[graph-duplex]``),
   serves 12 dialogues, three of them text-only (ASR delay), then 4 more in
   reused slots: every pushed frame
   is stepped, audio starts after the acoustic delay, every audio frame is
   1,920 finite samples, every dialogue ends, and the kernels launched
   exactly PER_TICK_DUPLEX per tick (the split ring pipeline; no fused
   commit); a kernel profile of its tick at 24 active slots; then the LM
   step, the Mimi encode step and the Mimi decode step through the kernels
   against the same steps through their plain versions (``[duplex-path]``),
   and the profile and the LM path check once more over full rings.
   ``[graph-duplex]``: the engine as ``build_duplex`` makes it from the file
   as shipped (pipeline_depth 2, its tick captured once as a CUDA graph:
   the key split, Mimi encode, the LM step with the DepFormer, the codec
   resets, the gated Mimi decode, the packing) serves the same workload with
   the eager engine's events (text, every frame bit for bit), its launches
   counted over its warm-up and capture (3 x per tick, none on replay); its
   tick is timed at depth 2 and at depth 1 (host ms, completion-to-completion
   interval, device busy share, launches and kernel ms from a profile, peak
   memory with the graph's pool); then the replay is held to the eager tick
   from one state over GRAPH_DUPLEX_TICKS ticks (past a wrap of the LM ring
   and both codec rings; slots opened, closed and reset, partial masks,
   text-only slots): the packed array bit for bit at every tick, the key and
   the whole state every 40 ticks and at the end; ``[graph-duplex-kv4]``
   (after ``[duplex-kv4]``) the same check over 40 ticks on packed-int4
   rings.
7b. The serving presets as shipped, after ``[graph-duplex-kv4]``:
   ``[graph-stt-serving]``: ``build_batched_asr`` from
   configs/config-stt-tpu-serving.toml (stt-1b, B=192, the step captured,
   ``pipeline_depth = 2``, the int16 upload wire) with every slot streaming
   STT_SERVING_FRAMES frames and a marker (past the LM ring's and the codec
   ring's wraps): its events (steps, words, markers, VAD probabilities' bits)
   equal to those of the same engine at depth 1, its launches counted over
   warm-up and capture (3 x per step); tick host ms and
   completion-to-completion at depth 2 and 1, a synchronous step's host ms,
   device busy, launches and kernel ms, peak memory, and the largest batch
   ``auto_batch_size`` fits on the card.  ``[graph-tts-serving]``:
   ``build_batched_tts`` from configs/config-tts-tpu-serving.toml (tts-1.6b,
   B=64, ``fuse_ticks = 4`` through the device script machine, one frame
   captured and replayed 4 times a dispatch, ``pipeline_depth = 2``,
   ``ca_int8``, the int16 wire) serves 65 sessions (one of 50 words, 8
   voices, a slot reused at frame TTS_SERVING_REUSE_AT): each session's
   events (words, times, audio words, Done) equal to the captured
   single-tick engine's (``fuse_ticks = 1``, depth 1, the same file and
   weights), its launches counted over warm-up and capture (3 x per frame);
   ms a dispatch and a frame, completion-to-completion, launches and kernel
   ms a dispatch, the delay to first audio in frames beside the single-tick
   engine's, the 52-op ``apply_ops`` and peak memory.  ``[graph-stt-serving]``
   then serves the same streams on an engine built with ``gc_tune=False``
   after ``gc.unfreeze()`` and CPython's default thresholds (events equal)
   and prints the max tick and the ticks over 80 ms with the GC frozen after
   warm-up (as shipped) and not.
7c. The load-and-start path, after the serving presets: ``[ckpt]``:
   configs/config-stt.toml (stt-1b) and configs/config-tts.toml (tts-1.6b) at
   full width, the builder's own seeded tree of each written to
   reference-layout bf16 safetensors by the port's writer, then each TOML
   built from those files through ``cli.build_engines`` and as shipped (the
   same seeded tree, in memory): every parameter bit for bit, the events of 4
   STT streams bit for bit, the load seconds printed.  ``[tts-single]``:
   configs/config-tts.toml as shipped (no ``batch_size``: the single-session
   ``TtsEngine``) but for ``[ckpt]``'s files and a ``voice_dir`` holding a
   synthetic 10 s ``.wav`` (through the speaker encoder); the engine from the
   files captured, the one from memory eager: one session with the voice
   over SINGLE_TICKS ticks past both rings' wraps, every tick bit for bit,
   exactly PER_TICK_TTS launches a tick on the eager side (the wrappers
   counted from 0 before it to after it; the captured engine's warm-up and
   capture 3 x per tick); the captured engine then synthesises 3 texts with
   the voice and 1 without: every word back, every frame 1,920 finite
   samples; host ms a tick of both, device launches and kernel ms a captured
   tick from a profile; ``[tts-single-path]``: the LM step with the voice and
   the Mimi decode at B=1 through the kernels against their plain versions.
   ``[mimi-rooms]``: a TOML with one ``type = "Mimi"`` module (n_q 16)
   through ``cli.build_engines`` and ``cli.start_engines`` (Mimi v0_1 at full
   width, bf16, its warm-up decode); two rooms decode ROOM_FRAMES frames
   each, interleaved, past the decoder ring's wrap: each room's pcm bit for
   bit an independent eager ``decode_step`` from a fresh state, the first
   ROOM_PLAIN_FRAMES within PATH_RTOL of the plain versions (``plain_seams``),
   exactly 8 ``rope_commit`` launches a frame and no other counted kernel;
   median and max host ms a frame.
7d. The serving layer's metrics (``server/metrics.py``): in
   ``[graph-stt-serving]``, ``[graph-tts-serving]``, ``[graph-duplex]`` and
   ``[tts-single]`` the registry's deltas over the phase's serving run equal
   what the phase counted (steps, ``fuse`` a fused dispatch; frames encoded
   and decoded; warm-ups; requests and audio seconds), the open-channels
   gauge back to 0, ``render()`` parses with every family, and the VRAM
   gauges agree with ``torch.cuda.mem_get_info`` and the allocator.
   ``[graph-stt-serving]``'s B=192 engine runs the native frame packer, as
   shipped; its depth-1 reference runs the deque mailboxes (the events bit
   for bit) with a session logger whose text tokens read back rebuild every
   slot's delivered words; the streams are fed a frame at a time, as
   clients send them.

8. The later paths, each at full width and depth: ``[stt1b-kv4]`` the stt-1b
   engine built with ``AsrConfig(kv_bits=4)`` (packed-int4 rings, uint8
   (64,16,768,64): quantize_commit with uint8 rows + decode_attend over the
   packed ring, never the fused commit), 12 sessions, its step time and peak
   memory beside the int8 engine's; ``[stt26-kv4]`` the stt-2.6b LM step over
   uint8 (64,32,384,32) rings against the plain path, after 40 steps and over
   full, wrapped rings of real quantised rows, timed beside the int8 rings;
   ``[duplex-kv4]`` the dialogue engine with ``kv_bits = 4`` (uint8
   (24,20,3072,64)), 8 dialogues, its profile over short and full rings and
   its peak memory.  Every path check counts the launches of both sides (the
   kernels' step launches them, the plain step none), and over full rings
   (``[duplex-full-path]``, ``[duplex-kv4-full-path]``, ``[stt26-kv4]``) a
   bit-identical pair fails; there decode_attend alone over int4 rings has a
   bar of its own (Q4_ALONE_FULL_RTOL); ``[tts202501]`` the TTS engine with
   the tts_202501 preset in place of the TOML's model (32 heads x 64, context
   500, DepFormer 32 slices x 6 layers; head-major voice cross-attention) at
   TTS202501_LAYERS of its 48 layers, the 16-session workload served eagerly
   and held by ``[graph-tts202501]``, with
   ``[tts202501-profile]`` and ``[tts202501-path]``; ``[tune]`` the
   decode-attention tuning tool (dsm_tpu_torch.tools.attn_kernel_tune) in
   process at --batch 64, each row held to a share of the reference's largest
   output.

9. The Moshi 7B family and the offline entry points, after
   ``[graph-duplex-kv4]``: ``[moshi-duplex]`` a TOML whose ``type = "Lm"``
   module names no ``[model]`` through ``build_duplex``: its default model,
   Moshi 7B in the dialogue layout (``moshi_v0_1_streaming(8)``: d=4096, 32
   layers of 32 heads x 128, 16 codebooks in, 8 generated), B=24,
   ``pipeline_depth = 2``, int8 rings (24,32,3072,128), W8A8, captured: the
   launches of its warm-up and capture (3 x PER_TICK_MOSHI), its tick timed,
   ``auto_batch_size``'s fit, the replay bit for bit the eager tick over
   GRAPH_DUPLEX_TICKS["moshi-duplex"] ticks past every ring's wrap; then the
   single-dialogue engine on the same weights for MOSHI_SINGLE_TICKS frames.
   ``[gen]`` ``cli gen`` in process (its default preset, bf16 weights and
   rings, ``--trace`` parsed, ``--out-tokens`` read back), then the same
   seeded model through ``lm_gen_simple.generate`` over GEN_STEPS steps at
   ``chunk`` 1 and GEN_CHUNK, the same tokens.  ``[tts-legacy]`` tts_v0_1 with
   T5-shaped states and a 10 s speaker sample through Mimi v0_1
   (``conditions``), LEGACY_STEPS steps with guidance, every written frame in
   range.  ``[offline]`` (after ``[mimi-rooms]``): ``transcribe_files`` at
   configs/config-stt.toml on audio/speech-synthetic.wav and a seeded wav,
   each result equal to ``transcribe_file`` and to the frame-at-a-time path,
   the realtime factor; ``synthesize_file`` at the end of ``[tts-single]`` on
   its captured engine and ``synthesize_jsonl`` (audio/tts.jsonl) in
   ``[graph-tts-serving]`` on its fused engine.

10. Training, after ``[tune]``, the serving engines freed: ``[train]``
   ``train.make_train_step`` on configs/config-tts.toml's tts-1.6b at full
   width (temporal 16 layers of d=2048; DepFormer 32 slices x 4 layers of
   d=1024, low-rank 128), f32 weights from ``LM.init`` on a seeded generator
   on the card, B=2 x 128 frames of seeded tokens: one step to warm up, then
   5 steps on the same batch, every loss finite and the last below the
   first, exactly 128 ``ring_commit`` (the DepFormer's slices into its f32
   ring (256, 16, 32, 64)) and 128 ``ring_commit_backward`` launches a step;
   median step ms, peak memory reserved, the parameter count.
   ``[train-path]``: the loss and its gradient at those widths cut to 2
   temporal layers and 4 slices through the kernels and through their plain
   versions (the same autograd Function, plain commit and plain backward):
   the losses equal, every gradient leaf bit for bit but the embedding
   tables' (index accumulation with atomics: relative L2 within
   TRAIN_EMB_REL_L2).  In the kernel phase, ``ring_commit`` at the DepFormer's
   ring and ``ring_commit_backward`` there (f32 and bf16, rows 0, C/2, C - 1)
   and at T = 2 rows into the codec's ring shape, bit for bit.

11. The device mesh (``dsm_tpu_torch/parallel/mesh.py``) after ``[train-path]``,
   on meshes that repeat the one card (each shard a separate engine on it):
   every engine served through its entry points (``open_channel`` /
   ``open_session`` and ``tick``: the shards' dispatch, pinned buffers and
   merge, dispatch-ahead).  ``[mesh-stt]`` configs/config-stt-tpu-serving.toml's
   stt-1b at B=64 (the builder's ``[mesh]`` of more shards than cards raises),
   64 channels of MESH_STEPS frames on the unmeshed engine, on dp = 2 (each
   shard's step its own captured graph; each channel's events bit for bit an
   unmeshed engine's of its shard's 32 slots) and on dp = 2 x tp = 2 (8 heads
   a shard, captured: each replica's two tp shards one graph, the joins
   summed on the card; words and VAD held to the dp engine's);
   ``[mesh-tts]`` (configs/config-tts-tpu-serving.toml as shipped, B=64;
   MESH_TTS_AUDIO frames past the 27-frame audio delay) and ``[mesh-duplex]``
   (configs/config-duplex-tpu-serving.toml, B=24; MESH_TICKS ticks on each),
   16 sessions on each engine, the dp engine's all equal to the unmeshed
   engine's (MESH_FRAME_RTOL), the captured dp x tp engine's held to the dp
   engine's (MESH_TP_SAME, MESH_TP_FRAME_RTOL).  At dp x tp in each: the
   launches over warm-up and capture (none on replay), the first
   MESH_EAGER_TICKS steps, frames or ticks beside the eager dp x tp engine
   (one host thread a tp shard, host joins) from the same state, every
   shard's device state (and the events so far) bit for bit, the host ms of
   both (the captured at most MESH_CAPTURED_SHARE of the eager), a profile of
   the captured step (device launches a shard, the joins' included; busy),
   the tp shards' states equal but for their LM heads; one LM step split
   over tp = 2 held to the unsplit step (``_tp_lm_check``).  The kernel phase holds every kernel of these
   paths at its per-shard shapes (labels "mesh ..."; the JSON entry's
   ``mesh_cases``).  One card cannot check another card's stream, cross-card
   copies or the per-device shared-memory opt-in
   (``tests/test_torch_cuda.py``'s two-card case).  ``[mesh-stt]`` also logs
   every channel's text tokens (``utils/session_log.SessionLogger``) on the
   dp and the dp x tp engine and holds the tp engine's to the dp engine's,
   step for step, pad tokens included (MESH_TP_TOKENS_SAME).
12. The benchmarks (``dsm_tpu_torch/bench_perf.py``) on the serving engines
   the phases before them built, each through its entry points at the 80 ms
   cadence for a few seconds (BENCH_S) with its drain capped
   (BENCH_DRAIN_S; the STT bench's own 15 s): ``[bench-duplex]`` ``bench_duplex_sustained`` on
   ``[graph-duplex]``'s B=24 engine, ``[bench-tts]`` ``bench_tts_sustained``
   on ``[graph-tts-serving]``'s fused engine (B=64, BENCH_TTS_WORDS words a
   session), ``[bench-stt]`` ``bench_server_sustained`` on
   ``[graph-stt-serving]``'s B=192 engine (depth 2, int16 wire, captured,
   native packer) and ``[bench-memory]`` ``bench_memory`` beside it.  Each
   prints its result dict; checked: every session's marker or Done, the
   engine stepped, every delivered frame 1,920 finite samples, the STT run's
   ``throughput_ok`` and its events rows in time order.  ``slo_ok`` and
   ``realtime_ok`` are measurements: printed, not checked.

After the paths each kernel case is timed: the kernel, its
plain version and its library call as device time (CUDA events around calls
queued behind a spin kernel, so the wrapper's host time stays out); beside
decode_attend_commit at the stt-1b, stt-2.6b and tts-1.6b rings, on the same
inputs, the split pipeline's ring_commit_q + decode_attend (``also``).  Each
kernel's JSON entry carries its bound: the larger of the bytes the case must
move at 3.35 TB/s and its operations at the card's peak for their type (67
TFLOP/s f32 outside the tensor cores; 989 TFLOP/s bf16 on them for qmm),
counted from the rows this run's mask lets in; and the library call's time
(``library_ms``): for the copy commits the in-place slice assignments that
compute the same function, for quantize_commit and quantize_scale_commit the
eager chain the parent ran on the same rows (its quantisation, then the copy
kernel: no single PyTorch call quantises and commits), for rope_commit and
rope_qk the parent's eager rotary embedding of q and k (then, for
rope_commit, its ring_commit of the rotated k and of v), for qmm
``torch._weight_int8pack_mm`` (no single PyTorch call computes the attention
kernels' function).  qmm is timed as the
serving step meets it: each call on another of 128 MiB of weight copies (the
weight cold in the 50 MB L2) and behind a kernel that writes x (in the step a
norm, the attention or the gate runs before every qmm), that kernel's own
time taken off; its warm time and its cold time back to back beside it; its
library call is timed the same way, and the pair ``wq.to(bf16)`` + matmul +
scale is an ``also`` line.  The entries named ``wrapper[rings]`` are the TPU kernels that the port serves
with another entry's kernel at other shapes or through another load path
(the packed-int4 rings): their numbers are that shape's.

Before them the ``[launches]`` lines: device launches and kernel ms a step
or tick of each path's profile beside those before the rope-and-commit
kernels (PERF.md section 5).  The
last three lines: the kernels' JSON (ring_commit_q and scale_commit with 0
launches: OFF_PATH; ring_commit and ring_commit_backward launched by the
training step only), the card's name and power limit, and
``{"ok": true,
"device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "quantize_scale_commit": "dsm_tpu_torch/csrc/ring_attn.cu",
    "quantize_commit": "dsm_tpu_torch/csrc/ring_attn.cu",
    "scale_commit": "dsm_tpu_torch/csrc/ring_attn.cu",
    "decode_attend_commit": "dsm_tpu_torch/csrc/decode_attn.cu",
    "ring_commit": "dsm_tpu_torch/csrc/ring_attn.cu",
    "ring_commit_backward": "dsm_tpu_torch/csrc/ring_attn.cu",
    "rope_commit": "dsm_tpu_torch/csrc/ring_attn.cu",
    "rope_qk": "dsm_tpu_torch/csrc/ring_attn.cu",
    "ca_decode_attend": "dsm_tpu_torch/csrc/ca_attn.cu",
    "ring_commit_q": "dsm_tpu_torch/csrc/ring_attn.cu",
    "decode_attend": "dsm_tpu_torch/csrc/decode_attn.cu",
    "qmm": "dsm_tpu_torch/csrc/qmm.cu",
    "attn_tune": "dsm_tpu_torch/csrc/attn_tune.cu",
}
REPLACES = {
    "quantize_scale_commit": "dsm_tpu/ops/ring_kernels.py:160",
    "quantize_commit": "dsm_tpu/ops/ring_kernels.py:66",
    "scale_commit": "dsm_tpu/ops/ring_kernels.py:160",
    "decode_attend_commit": "dsm_tpu/ops/decode_attn.py:545",
    "ring_commit": "dsm_tpu/ops/ring_kernels.py:120",
    # No Pallas kernel: the transpose of the ring commit (_ring_commit), which
    # JAX's autodiff derives when training differentiates the DepFormer step.
    "ring_commit_backward": "dsm_tpu/ops/transformer.py:552",
    "rope_commit": "dsm_tpu/ops/ring_kernels.py:120",
    # No Pallas kernel: the rope that XLA fuses before _ring_commit_q and _scale_commit.
    "rope_qk": "dsm_tpu/ops/attention.py:49",
    "ca_decode_attend": "dsm_tpu/ops/decode_attn.py:960",
    "ring_commit_q": "dsm_tpu/ops/ring_kernels.py:66",
    "decode_attend": "dsm_tpu/ops/decode_attn.py:215",
    "qmm": "dsm_tpu/ops/qmm.py:42",
    "attn_tune": "tools/attn_kernel_tune.py:42",
}
# The literal counterparts of TPU kernels 4 and 1 on rows quantised already:
# built and held to their plain versions, but the step quantises its fresh
# rows in the commit (quantize_commit, quantize_scale_commit) and launches
# them no more.  Their JSON entries say so, with 0 launches.  ring_commit, the
# counterpart of kernel 3 on rows rotated already, no serving path launches
# (rope_commit takes its place there); the training step launches it in the
# DepFormer, whose slices have no rotary embedding ([train]).
OFF_PATH = {"ring_commit_q": "quantize_commit", "scale_commit": "quantize_scale_commit"}
# TPU kernels that the port serves with one of the kernels above at other
# shapes: JSON name -> (wrapper, TPU kernel, the path that launches it there).
ROUTES = {
    "decode_attend[stt-1b rings]": ("decode_attend", "dsm_tpu/ops/decode_attn.py:384",
                                    "stt1b_split"),
    "decode_attend[stt-2.6b rings]": ("decode_attend", "dsm_tpu/ops/decode_attn.py:59",
                                      "stt26"),
    "decode_attend[tts_202501 rings]": ("decode_attend", "dsm_tpu/ops/decode_attn.py:59",
                                        "tts202501"),
    "decode_attend_commit[stt-2.6b rings]": ("decode_attend_commit",
                                             "dsm_tpu/ops/decode_attn.py:661", "stt26_fused"),
    "decode_attend[(64,16,768,64) int4]": ("decode_attend", "dsm_tpu/ops/decode_attn.py:461",
                                           "stt1b_kv4"),
    "decode_attend[(64,32,384,32) int4]": ("decode_attend", "dsm_tpu/ops/decode_attn.py:135",
                                           "stt26_kv4"),
    "ca_decode_attend[(64,32,640,64)]": ("ca_decode_attend", "dsm_tpu/ops/decode_attn.py:898",
                                         "tts202501"),
    "decode_attend[(24,32,3072,128) moshi]": ("decode_attend", "dsm_tpu/ops/decode_attn.py:215",
                                              "moshi_duplex"),
    "quantize_commit[(24,32,3072,128) moshi]": ("quantize_commit",
                                                "dsm_tpu/ops/ring_kernels.py:66", "moshi_duplex"),
}
# Launches per engine step of the STT path: each of the LM's 16 layers
# rotates q and k (rope_qk), quantises its fresh rows and commits their
# scales (quantize_scale_commit) and attends over its int8 ring with the
# fused commit; the Mimi encoder transformer's 8 layers rotate q and k and
# commit their bf16 rows in one launch (rope_commit).  The copy kernels of
# rows quantised or rotated already launch on no serving path.
_NONE = {"scale_commit": 0, "ring_commit_q": 0, "ring_commit": 0}
PER_STEP = {"rope_qk": 16, "quantize_scale_commit": 16, "decode_attend_commit": 16,
            "rope_commit": 8, "quantize_commit": 0, **_NONE}
# Launches per engine tick of the TTS path: each of the LM's 16 layers as
# above plus its voice cross-attention over the int8 store; the Mimi
# decoder transformer's 8 layers rotate and commit their 2 bf16 rows (T=2).
# The DepFormer (no positional embedding, a dense slice cache) and the conv
# stacks run no kernel.
PER_TICK_TTS = {"rope_qk": 16, "quantize_scale_commit": 16, "decode_attend_commit": 16,
                "rope_commit": 8, "ca_decode_attend": 16, "quantize_commit": 0,
                "decode_attend": 0, **_NONE}
# Launches per engine step of the stt-2.6b path: 32 heads x 64 are not a
# shape of the fused rule, so each of the LM's 48 layers quantises and
# commits its int8 rows and scales with quantize_commit and attends with
# decode_attend (one span); its 4 matmuls and the text head are weight-only:
# qmm; Mimi as above.
PER_STEP_STT26 = {"rope_qk": 48, "quantize_commit": 48, "decode_attend": 48, "rope_commit": 8,
                  "qmm": 193,
                  "quantize_scale_commit": 0, "decode_attend_commit": 0, **_NONE}
# Launches per engine tick of the duplex path: s2s-2b's 20 heads over a
# 3072-row ring are not a shape of the fused commit, so each of the LM's 24
# layers quantises and commits its int8 rows and scales with quantize_commit
# and attends with decode_attend; the Mimi encoder's and decoder's 8 layers
# each rotate and commit their 2 bf16 rows.
PER_TICK_DUPLEX = {"rope_qk": 24, "quantize_commit": 24, "decode_attend": 24, "rope_commit": 16,
                   "quantize_scale_commit": 0, "decode_attend_commit": 0, **_NONE}
# stt-1b with packed-int4 rings: an int4 ring never takes the fused commit, so
# each of the 16 layers quantises, packs and commits its uint8 rows and scales
# with quantize_commit and attends with decode_attend over the packed ring.
PER_STEP_STT1B_KV4 = {"rope_qk": 16, "quantize_commit": 16, "decode_attend": 16, "rope_commit": 8,
                      "quantize_scale_commit": 0, "decode_attend_commit": 0, **_NONE}
# tts_202501 (32 heads x 64, not a shape of the fused rule) at TTS202501_LAYERS
# of its 48 layers (all of them since the dp x tp step is captured and the
# mesh phases take less time): the split pipeline over
# (64,32,512,64) int8 rings plus the voice cross-attention in every layer; the
# Mimi decoder's 8 layers rotate and commit their 2 bf16 rows.
TTS202501_LAYERS = 48
PER_TICK_TTS202501 = {"rope_qk": TTS202501_LAYERS, "quantize_commit": TTS202501_LAYERS,
                      "decode_attend": TTS202501_LAYERS, "ca_decode_attend": TTS202501_LAYERS,
                      "rope_commit": 8, "quantize_scale_commit": 0,
                      "decode_attend_commit": 0, **_NONE}
# Device launches and kernel ms a step or tick on each path before the step
# folded the rotary embedding into its commits (the figures PERF.md section 5
# gave then, NVIDIA H100 80GB HBM3, 700.00 W): printed beside this run's (the
# ``[launches]`` lines).  The key is the profile's tag.
PARENT_PROFILE = {"profile": ("stt-1b step", 2858, 10.26),
                  "stt26-profile": ("stt-2.6b step", 3608, 13.43),
                  "duplex-profile": ("duplex tick, short rings", 19971, 46.14),
                  "tts-profile": ("TTS tick", 18164, 54.77),
                  "stt1b-kv4-profile": ("[stt1b-kv4] step", 2842, 9.93)}
# The bf16 K/V ring of each Mimi transformer layer in the duplex engine
# (B=24, 8 heads, context 250 + T=2 rows rounded up to 256, Dh=64).
DUPLEX_MIMI_RING = (24, 8, 256, 64)
ATOL = RTOL = 2e-2
REPEATS = 3  # kernel runs per case in the kernel phase
PATH_RTOL = 2e-2  # the TTS path through the kernels against its plain versions
# A path over full rings: every layer's attention sums hundreds to thousands
# of rows, more output elements differ by a rounding step between two orders
# of summation, and the layers after (int8 activations, 24 to 48 of them,
# random weights) amplify them: the stt-2.6b step reads 0.034 with qmm alone
# through its kernel, int8 and int4 rings alike.  The sharp check there is
# SEAM_RTOL: each decode_attend launch against its plain version on the same
# operands (a dropped row of 3,072 equal ones would move it by 0.018).
FULL_RING_RTOL = 5e-2
SEAM_RTOL = 1e-3
# decode_attend alone (with quantize_commit, bit for bit its plain version)
# through its kernel over full wrapped packed-int4 rings: the step's relative
# L2 from the plain step, held to at most twice what the previous packed-int4
# kernel (one 16-byte register load in flight a lane) read there (0.0116 at
# [stt26-kv4], 0.0258 at [duplex-kv4-full-path]; NVIDIA H100 80GB HBM3, 700 W)
# and to no more than the bar it had before (PATH_RTOL at [stt26-kv4],
# FULL_RING_RTOL on the duplex path, which cannot bound it).
Q4_ALONE_FULL_RTOL = {"stt26-kv4": 0.02, "duplex-kv4": 0.04}
ROW_RTOL = 5e-2  # a freshly quantised ring row of one route against the other's
# The case whose times stand in the kernels' JSON line: the full STT
# rings, and the TTS serving voice source; for ring_commit and its backward
# the DepFormer's ring of the training step, the one path that launches them.
HEADLINE = {"quantize_scale_commit": "stt1b int8 w=767", "quantize_commit": "stt26 int8 w=383",
            "scale_commit": "stt w=767", "decode_attend_commit": "stt pos=3000 valid=1.0",
            "ring_commit": "depformer f32 w=16", "rope_commit": "stt w=254",
            "ring_commit_backward": "depformer f32 w=16",
            "rope_qk": "stt1b (64,16,1,128)", "ca_decode_attend": "B=64 H=16 S=625/640 Dh=128",
            "ring_commit_q": "duplex w=3071",
            "decode_attend": "duplex pos=10000 valid=1.0 split=1",
            "qmm": "M=64 O=11264 I=2048",
            "decode_attend[stt-1b rings]": "stt1b pos=3000 valid=1.0 split=1",
            "decode_attend[stt-2.6b rings]": "stt26 pos=3000 valid=1.0 split=1",
            "decode_attend[tts_202501 rings]": "tts202501 pos=3000 valid=1.0 split=1",
            "decode_attend_commit[stt-2.6b rings]": "stt26 pos=3000 valid=1.0",
            "decode_attend[(64,16,768,64) int4]": "stt1b-kv4 pos=3000 valid=1.0 split=1",
            "decode_attend[(64,32,384,32) int4]": "stt26-kv4 pos=3000 valid=1.0 split=1",
            "ca_decode_attend[(64,32,640,64)]": "B=64 H=32 S=625/640 Dh=64",
            "decode_attend[(24,32,3072,128) moshi]": "moshi pos=10000 valid=1.0 split=1",
            "quantize_commit[(24,32,3072,128) moshi]": "moshi int8 w=3071",
            "attn_tune": "pos=3000 valid=0.9 bb=1"}
# The training step ([train]): configs/config-tts.toml's tts-1.6b at full
# width, B=2 sequences of TRAIN_FRAMES frames, TRAIN_STEPS timed steps after
# one to warm up; the DepFormer's ring holds B * TRAIN_FRAMES rows.
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS = 2, 128, 5
DEPFORMER_RING = (TRAIN_BATCH * TRAIN_FRAMES, 16, 32, 64)
# [train-path]: the step cut to 2 temporal layers and 4 DepFormer slices.
TRAIN_PATH_LAYERS, TRAIN_PATH_SLICES = 2, 4
# Embedding tables: their gradient is an index accumulation (atomics on the
# card), so two runs may sum a row's contributions in another order; every
# other leaf of [train-path] is held bit for bit.
TRAIN_EMB_REL_L2 = 1e-6
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
QMM_REL_L2 = 2e-3  # qmm against its plain version
# The tuning tool's rows against attend_global_split_q on its random rings, as
# a share of the reference's largest output: the bf16 variants, i8s, i8sp.
TUNE_REL_BARS = {"": 2e-2, "i8s": 3e-2, "i8sp": 8e-2}
TUNE_VARIANTS = {"bb=1": {"bb": 1}, "bb=4": {"bb": 4}, "bb=4 i8s": {"bb": 4, "i8s": True},
                 "bb=4 i8sp": {"bb": 4, "i8s": True, "i8p": True},
                 "bb=2 i8p": {"bb": 2, "i8p": True}}
# The stt-2.6b matmuls at B=64 (in_proj, out_proj, the gated MLP's two, the
# text head), then a single row and the duplex batch.
QMM_SHAPES = ((64, 6144, 2048), (64, 2048, 2048), (64, 11264, 2048), (64, 2048, 5632),
              (64, 4000, 2048), (1, 2048, 2048), (24, 2048, 2048))


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _metric_values() -> dict:
    """Every sample of the port's metric registry: (name, labels) -> value."""
    from dsm_tpu_torch.server import metrics as M

    return {(smp.name, tuple(sorted(smp.labels.items()))): smp.value
            for fam in M.collect() for smp in fam.samples}


def _check_metrics(tag, before, want, dev, card, approx=()):
    """The registry's deltas since ``before`` against ``want`` ({sample name:
    count}, exact; those named in ``approx`` within 1e-9 relative: float sums
    in another order); the exposition parses with every family; the VRAM
    gauges agree with ``torch.cuda.mem_get_info`` and the allocator's bytes."""
    import torch

    from dsm_tpu_torch.server import metrics as M

    after = _metric_values()
    got = {name: after.get((name, ()), 0.0) - before.get((name, ()), 0.0) for name in want}
    for name, value in want.items():
        ok = (abs(got[name] - value) <= 1e-9 * abs(value) if name in approx
              else got[name] == value)
        check(ok, f"{tag}: metric {name} moved by {got[name]!r}, the phase counted {value!r}")
    types, n_samples = {}, 0
    for line in M.render().decode().splitlines():
        if line.startswith("# TYPE "):
            types[line.split()[2]] = line.split()[3]
        elif line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
            n_samples += 1
    check(set(types) == M.rendered_families() and set(M.REFERENCE_FAMILIES) <= set(types),
          f"{tag}: /metrics text lacks families")
    M.update_device_memory(dev)
    free, total = torch.cuda.mem_get_info(dev)
    allocated = torch.cuda.memory_allocated(dev)
    gauges = (M.DEVICE_MEM_FREE.get(), M.DEVICE_MEM_USED.get(), M.DEVICE_MEM_TOTAL.get(),
              M.MEMORY_CURRENT_VRAM.get())
    check(gauges[2] == total and gauges[0] + gauges[1] == total
          and abs(gauges[0] - free) <= 64 << 20 and gauges[3] == allocated
          and M.MEMORY_PEAK_VRAM.get() >= allocated,
          f"{tag}: VRAM gauges {gauges} against mem_get_info ({free}, {total}) and "
          f"{allocated} allocated")
    print(f"[{tag}] metrics: the registry moved as the phase counted {got}; /metrics parses "
          f"({len(types)} families, {n_samples} samples); VRAM gauges free "
          f"{gauges[0] / 1e9:.2f} GB of {gauges[2] / 1e9:.2f} (mem_get_info {free / 1e9:.2f}), "
          f"allocated {gauges[3] / 1e9:.2f} GB; card {card}", flush=True)
    return got


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_CLOCK = {"start": None, "last": None}


def elapsed(phase: str) -> None:
    """Print the wall time of the phase that just ended and of the run so
    far: where the script's time limit goes."""
    now = time.perf_counter()
    if _CLOCK["start"] is None:
        _CLOCK["start"] = _CLOCK["last"] = now
    print(f"[elapsed] {phase}: {now - _CLOCK['last']:.1f} s, {now - _CLOCK['start']:.1f} s "
          f"since the start", flush=True)
    _CLOCK["last"] = now


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _within(a, p) -> bool:
    a, p = a.float(), p.float()
    return bool(((a - p).abs() <= ATOL + RTOL * p.abs()).all())


def _close(name: str, a, p) -> float:
    """Check an attention output against its plain version; its max error."""
    import torch

    check(bool(torch.isfinite(a).all()), f"{name} output not finite")
    check(_within(a, p), f"{name} output outside {ATOL} of its plain version")
    return float((a.float() - p.float()).abs().max())


def _exact(got, want) -> float:
    import torch

    for a, b in zip(got, want):
        check(torch.equal(a, b), "kernel ring differs from its plain version")
    return 0.0


def _bound(info):
    """The least time the card could take for a case -> ``(ms, bound_by)``."""
    t_bytes = info["bytes"] / MEM_BYTES_PER_S * 1e3
    t_ops = info["flops"] / info.get("peak", F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _commit_info(rings, news, w):
    """A commit reads its new rows once and writes them once; the library
    call beside it is the in-place slice assignment of each ring."""
    t = news[0].shape[2]

    def library():
        for ring, new in zip(rings, news):
            ring[:, :, w:w + t] = new

    return {"bytes": 2 * sum(x.numel() * x.element_size() for x in news), "flops": 0,
            "library": library}


def _attend_info(n_rows, b, h, c, dh, row_bytes=None):
    """Decode attention over ``n_rows`` attended (b, row) pairs: each row's
    int8 K and V (``row_bytes`` each: Dh, or Dh/2 packed) and its two f32
    scales for every head, the validity bitmap, q, the fresh K/V rows and
    the output in bf16; 2 multiply-adds a value."""
    rows = n_rows * h
    return {"bytes": rows * (2 * (row_bytes or dh) + 8) + b * c + 4 * b * h * dh * 2,
            "flops": rows * 4 * dh, "library": None}


def _tick(pos, dev):
    """A position as the kernels' wrappers take it: the step's 0-d int32
    tensor on the card, made once per case (the plain versions take the
    int)."""
    import torch

    return torch.tensor(pos, dtype=torch.int32, device=dev)


def _commit_case(name, label, kern, plain, k0, v0, kn, vn, w):
    """The kernel's wrapper reads the position from the card, here a wrapped
    one (``w + 2C``: the kernel takes it modulo C); the plain version gets
    ``w``."""
    rk, rv, pk, pv = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    pos = _tick(w + 2 * k0.shape[2], k0.device)

    def run_k():
        kern(rk, rv, kn, vn, pos)
        return rk, rv

    def run_p():
        plain(pk, pv, kn, vn, w)
        return pk, pv

    return name, label, run_k, run_p, _exact, _commit_info((rk, rv), (kn, vn), w)


def _commit_backward_case(label, gk, gv, t, w):
    """The ring commit's backward: the kernel reads the position from the
    card (``w + 2C``), the plain version gets ``w``.  It reads both rings'
    gradients once and writes them once, with the new rows' gradients."""
    from dsm_tpu_torch.ops import ring_kernels as RK

    pos = _tick(w + 2 * gk.shape[2], gk.device)
    ring_bytes = gk.numel() * gk.element_size()
    row_bytes = ring_bytes // gk.shape[2] * t

    def run_k():
        return RK.ring_commit_backward(gk, gv, pos, t)

    def run_p():
        return RK.ring_commit_backward_plain(gk, gv, w, t)

    return ("ring_commit_backward", label, run_k, run_p, _exact,
            {"bytes": 2 * (2 * ring_bytes + row_bytes), "flops": 0, "library": None})


def _ring_backward_cases(dev, g):
    """The DepFormer's ring in training ((B*T, 16, 32, 64) at B*T = 256, f32,
    one row a slice): the commit, and its backward at f32 and bf16, at the
    first, the middle and the last row; the backward at T = 2 rows into the
    codec's ring shape (64, 8, 256, 64), f32 and bf16, at rows 0, C/2 and
    C - 2."""
    import torch

    from dsm_tpu_torch.ops import ring_kernels as RK

    cases = []
    b, h, c, dh = DEPFORMER_RING
    kc, vc = (torch.randn(b, h, c, dh, generator=g, device=dev) for _ in range(2))
    kn, vn = (torch.randn(b, h, 1, dh, generator=g, device=dev) for _ in range(2))
    for w in (0, c // 2, c - 1):
        cases.append(_commit_case("ring_commit", f"depformer f32 w={w}", RK.ring_commit,
                                  RK.ring_commit_plain, kc, vc, kn, vn, w))
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gk, gv = kc.to(dtype), vc.to(dtype)
        for w in (0, c // 2, c - 1):
            cases.append(_commit_backward_case(f"depformer {name} w={w}", gk, gv, 1, w))
        gk, gv = (torch.randn(64, 8, 256, 64, generator=g, device=dev).to(dtype)
                  for _ in range(2))
        for w in (0, 128, 254):
            cases.append(_commit_backward_case(f"T=2 (64,8,256,64) {name} w={w}", gk, gv,
                                               2, w))
    return cases


def _true_mask(valid, pos, c, window):
    """The ring rows ``(B, C)`` a decode step at ``pos`` attends."""
    import torch

    j = torch.arange(c, device=valid.device)
    dist = torch.remainder(pos % c - j, c)
    return ((dist != 0) & (dist <= pos) & (dist < window))[None, :] & valid


def _sharp_scales(g, dev, *shape):
    """Key scales that peak the softmax (score spread about 3.7) and value
    scales that make the outputs O(1), so that one row too many or too few
    moves an output past the bar."""
    import torch

    ks = torch.rand(*shape, generator=g, device=dev) * 0.04 + 0.08
    vs = torch.rand(*shape, generator=g, device=dev) * 0.01 + 0.005
    return ks, vs


def _attend_cases(dev, g, tag, b, h, c, dh, window, sharp, positions, timed=()):
    """decode_attend_commit over one int8 ring at ``positions`` ((pos,
    valid share) pairs), held to its plain version in the kernel's span
    order (its own n_split) and to the whole-ring order.  With ``sharp``
    scales a partial mask must also be seen by the bar: every row valid
    instead has to fail it.  At the positions in ``timed`` the timing phase
    also runs, on the same inputs, the split pipeline's pair (ring_commit_q
    + decode_attend over the committed ring)."""
    import torch

    from dsm_tpu_torch.ops import attention as A
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import ring_kernels as RK

    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    k_new = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    v_new = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    kring = torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev, dtype=torch.int8)
    vring = torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev, dtype=torch.int8)
    if sharp:
        kscale, vscale = _sharp_scales(g, dev, b, h, c)
    else:
        kscale = torch.rand(b, h, c, generator=g, device=dev) * 0.019 + 0.001
        vscale = torch.rand(b, h, c, generator=g, device=dev) * 0.019 + 0.001
    kq, vq, ksn, vsn = A.quantize_kv_rows(k_new, v_new)
    rows = [x[:, :, 0].contiguous() for x in (q, kq, vq, k_new, v_new)]
    n_split = DA.pick_split(b * h, c)
    cases = []
    for pos, frac in positions:
        valid = torch.rand(b, c, generator=g, device=dev) < frac
        plan = A.global_ring_plan(pos, c, 1, device=dev)
        w = plan["w"][0]
        rk, rv, pk, pv = kring.clone(), vring.clone(), kring.clone(), vring.clone()

        def run_k(rk=rk, rv=rv, plan=plan, valid=valid):
            y = DA.decode_attend_commit(q, rk, rv, kscale, vscale, kq, vq, k_new, v_new,
                                        plan, valid, window=window)[0]
            return y[:, :, 0], rk, rv

        def run_p(pk=pk, pv=pv, valid=valid, pos=pos, w=w):
            y = DA.decode_attend_commit_plain(rows[0], pk, pv, kscale, vscale, *rows[1:],
                                              valid, pos, w, window, n_split)
            return y, pk, pv

        def cmp(got, want, valid=valid, pos=pos, w=w, frac=frac):
            _exact(got[1:], want[1:])
            err = _close("decode_attend_commit", got[0], want[0])
            whole = DA.decode_attend_commit_plain(rows[0], kring.clone(), vring.clone(), kscale,
                                                  vscale, *rows[1:], valid, pos, w, window)
            check(_within(got[0], whole), "decode_attend_commit: output outside the bar of "
                  "the whole-ring order")
            if sharp and frac < 1.0:
                alt = DA.decode_attend_commit_plain(
                    rows[0], kring.clone(), vring.clone(), kscale, vscale, *rows[1:],
                    torch.ones_like(valid), pos, w, window)
                check(not _within(alt, want[0]),
                      "decode_attend_commit: the bar does not see a wrong mask")
            return err

        n_rows = int(_true_mask(valid, pos, c, window).sum())
        info = _attend_info(n_rows, b, h, c, dh)
        if pos in timed:
            sk, sv, sks, svs = kring.clone(), vring.clone(), kscale.clone(), vscale.clone()

            def split_pair(sk=sk, sv=sv, sks=sks, svs=svs, plan=plan, valid=valid):
                RK.ring_commit(sk, sv, kq, vq, plan["pos"], sks, svs, ksn, vsn)
                DA.decode_attend(q, sk, sv, sks, svs, k_new, v_new, plan, valid,
                                 window=window)

            info["also"] = {"ring_commit_q + decode_attend": split_pair}
        cases.append(("decode_attend_commit", f"{tag} pos={pos} valid={frac}",
                      run_k, run_p, cmp, info))
    return cases


def _split_inputs(dev, g, b, h, c, dh, pos, window, frac):
    """A committed int8 ring with O(1) outputs on which a wrong mask shows:
    the oldest attended row matches the query best (score 14 against a
    spread of about 3.7), and ring row w (this step's committed row, which
    the mask excludes) would match it better still (score 26) with values
    of 127 at scale 1.  Returns the operands and the oldest attended row's
    ring index (None when no row is attended)."""
    import math

    import torch

    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
                       for _ in range(3))
    kc, vc = (torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = _sharp_scales(g, dev, b, h, c)
    valid = torch.rand(b, c, generator=g, device=dev) < frac
    w = pos % c
    qf = q[:, :, 0].float()
    aligned = torch.where(qf >= 0, 127, -127).to(torch.int8)
    per_scale = 127.0 * qf.abs().sum(-1) / math.sqrt(dh)  # score per unit k_scale
    kc[:, :, w] = aligned
    ks[:, :, w] = 26.0 / per_scale
    vc[:, :, w] = 127
    vs[:, :, w] = 1.0
    valid[:, w] = True
    d_max = min(pos, window - 1, c - 1)
    oldest = None
    if d_max >= 1:
        oldest = (w - d_max) % c
        kc[:, :, oldest] = aligned
        ks[:, :, oldest] = 14.0 / per_scale
        valid[:, oldest] = True
    return (q, kc, vc, ks, vs, k_new, v_new, valid), oldest


def _attend_with_mask(q, kc, vc, ks, vs, k_new, v_new, ok, fresh=True):
    """Decode attention over the ring rows ``ok (B, C)`` lets in plus the
    fresh row (unless ``fresh`` is off), written independently of the port's
    plain version (one softmax, no bf16 rounding): what a kernel with that
    mask would give."""
    import torch

    scale = q.shape[-1] ** -0.5
    qf = q[:, :, 0].float()
    s = torch.einsum("bhd,bhcd->bhc", qf, kc.float()) * ks * scale
    s = torch.where(ok[:, None, :], s, float("-inf"))
    s_new = (qf * k_new[:, :, 0].float()).sum(-1, keepdim=True) * scale
    if not fresh:
        s_new = torch.full_like(s_new, float("-inf"))
    p = torch.softmax(torch.cat([s, s_new], dim=-1), dim=-1)
    out = torch.einsum("bhc,bhcd->bhd", p[..., :-1] * vs, vc.float())
    return out + p[..., -1:] * v_new[:, :, 0].float()


def _split_cases(dev, g, tag, b, h, c, dh, window, positions):
    """decode_attend over one committed int8 ring at ``positions`` ((pos,
    valid share) pairs), unsplit and at the split the wrapper picks.  The
    bar must see a wrong mask: the oldest attended row dropped, the
    committed row w let in, every ring row let in (each through the
    independent masked attention, held against the plain version)."""
    import torch

    from dsm_tpu_torch.ops import attention as A
    from dsm_tpu_torch.ops import decode_attn as DA

    cases = []
    for pos, frac in positions:
        args, oldest = _split_inputs(dev, g, b, h, c, dh, pos, window, frac)
        valid = args[7]
        plan = A.global_ring_plan(pos, c, 1, device=dev)
        rows = [x[:, :, 0].contiguous() for x in (args[0], args[5], args[6])]
        n_rows = int(_true_mask(valid, pos, c, window).sum())
        for n_split in sorted({1, DA.card_split(b * h, c, dh, False, dev)}):

            def run_k(args=args, plan=plan, valid=valid, n_split=n_split):
                return (DA.decode_attend(*args[:7], plan, valid, window=window,
                                         n_split=n_split)[:, :, 0],)

            def run_p(args=args, rows=rows, valid=valid, pos=pos, n_split=n_split):
                return (DA.decode_attend_plain(rows[0], *args[1:5], rows[1], rows[2], valid,
                                               pos, pos % c, window, n_split),)

            def cmp(got, want, args=args, valid=valid, pos=pos, oldest=oldest):
                err = _close("decode_attend", got[0], want[0])
                ok = _true_mask(valid, pos, c, window)
                check(_within(_attend_with_mask(*args[:7], ok), want[0]),
                      "decode_attend: the plain version is outside the bar of an "
                      "independent masked attention")
                wrong = {"the committed row w let in": ok.clone(),
                         "every ring row let in": torch.ones_like(ok)}
                wrong["the committed row w let in"][:, pos % c] = True
                if oldest is None:  # only the fresh row attends: garbage ignored
                    check(_within(got[0], args[6][:, :, 0]),
                          "decode_attend: an empty ring's output is not the fresh row")
                else:
                    wrong["the oldest attended row dropped"] = ok.clone()
                    wrong["the oldest attended row dropped"][:, oldest] = False
                for what, mask in wrong.items():
                    check(not _within(_attend_with_mask(*args[:7], mask), want[0]),
                          f"decode_attend: the bar does not see {what}")
                return err

            cases.append(("decode_attend", f"{tag} pos={pos} valid={frac} split={n_split}",
                          run_k, run_p, cmp, _attend_info(n_rows, b, h, c, dh)))
    return cases


def _split_inputs_q4(dev, g, b, h, c, dh, pos, window, frac):
    """:func:`_split_inputs` for a packed-int4 ring: values in [-7, 7], packed
    here apart from the port's ``pack4`` (byte d = (x[d] + 8) + 16 (x[d + Dh/2]
    + 8)), scales 18 times the int8 ones (the same score spread, O(1)
    outputs).  Returns the operands, the unpacked K and V values (what an
    independent attention reads) and the oldest attended row."""
    import math

    import torch

    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
                       for _ in range(3))
    kv, vv = (torch.randint(-7, 8, (b, h, c, dh), generator=g, device=dev, dtype=torch.int32)
              for _ in range(2))
    ks, vs = (18.0 * x for x in _sharp_scales(g, dev, b, h, c))
    valid = torch.rand(b, c, generator=g, device=dev) < frac
    w = pos % c
    qf = q[:, :, 0].float()
    aligned = torch.where(qf >= 0, 7, -7).to(torch.int32)
    per_scale = 7.0 * qf.abs().sum(-1) / math.sqrt(dh)  # score per unit k_scale
    kv[:, :, w] = aligned
    ks[:, :, w] = 26.0 / per_scale
    vv[:, :, w] = 7
    vs[:, :, w] = 18.0
    valid[:, w] = True
    d_max = min(pos, window - 1, c - 1)
    oldest = None
    if d_max >= 1:
        oldest = (w - d_max) % c
        kv[:, :, oldest] = aligned
        ks[:, :, oldest] = 14.0 / per_scale
        valid[:, oldest] = True

    def pack(x):
        return ((x[..., :dh // 2] + 8) + 16 * (x[..., dh // 2:] + 8)).to(torch.uint8)

    return (q, pack(kv), pack(vv), ks, vs, k_new, v_new, valid), (kv, vv), oldest


def _split_cases_q4(dev, g, tag, b, h, c, dh, window, positions):
    """decode_attend over one committed packed-int4 ring (uint8, Dh/2 bytes a
    row) at ``positions``, unsplit (the fresh row folded in the kernel's one
    launch), at the split the wrapper picks and at three spans (the fold
    kernel).  The
    bar must see a wrong mask, as in :func:`_split_cases`, and the nibble
    halves read the other way round (of K and of V, through the plain
    version on a ring with its nibbles swapped)."""
    import torch

    from dsm_tpu_torch.ops import attention as A
    from dsm_tpu_torch.ops import decode_attn as DA

    cases = []
    for pos, frac in positions:
        args, vals, oldest = _split_inputs_q4(dev, g, b, h, c, dh, pos, window, frac)
        valid = args[7]
        check(args[1].dtype == torch.uint8 and tuple(args[1].shape) == (b, h, c, dh // 2),
              "not a packed-int4 ring")
        plan = A.global_ring_plan(pos, c, 1, device=dev)
        rows = [x[:, :, 0].contiguous() for x in (args[0], args[5], args[6])]
        n_rows = int(_true_mask(valid, pos, c, window).sum())
        for n_split in sorted({1, DA.card_split(b * h, c, dh, True, dev), 3}):

            def run_k(args=args, plan=plan, valid=valid, n_split=n_split):
                return (DA.decode_attend(*args[:7], plan, valid, window=window,
                                         n_split=n_split)[:, :, 0],)

            def plain(args, rows=rows, valid=valid, pos=pos, n_split=n_split):
                return DA.decode_attend_plain(rows[0], *args[1:5], rows[1], rows[2], valid,
                                              pos, pos % c, window, n_split)

            def run_p(args=args, plain=plain):
                return (plain(args),)

            def cmp(got, want, args=args, vals=vals, valid=valid, pos=pos, oldest=oldest,
                    plain=plain):
                err = _close("decode_attend (int4)", got[0], want[0])
                ok = _true_mask(valid, pos, c, window)
                ref = (args[0], *vals, *args[3:7])
                check(_within(_attend_with_mask(*ref, ok), want[0]),
                      "decode_attend (int4): the plain version is outside the bar of an "
                      "independent masked attention over the unpacked values")
                wrong = {"the committed row w let in": ok.clone(),
                         "every ring row let in": torch.ones_like(ok)}
                wrong["the committed row w let in"][:, pos % c] = True
                if oldest is None:  # only the fresh row attends: zero bytes (-8) ignored
                    check(_within(got[0], args[6][:, :, 0]),
                          "decode_attend (int4): an empty ring's output is not the fresh row")
                else:
                    wrong["the oldest attended row dropped"] = ok.clone()
                    wrong["the oldest attended row dropped"][:, oldest] = False
                    for which, what in ((1, "K"), (2, "V")):
                        swapped = list(args)
                        swapped[which] = (args[which] >> 4) | ((args[which] & 15) << 4)
                        check(not _within(plain(swapped), want[0]),
                              f"decode_attend (int4): the bar does not see swapped nibble "
                              f"halves of {what}")
                for what, mask in wrong.items():
                    check(not _within(_attend_with_mask(*ref, mask), want[0]),
                          f"decode_attend (int4): the bar does not see {what}")
                return err

            cases.append(("decode_attend", f"{tag} pos={pos} valid={frac} split={n_split}",
                          run_k, run_p, cmp, _attend_info(n_rows, b, h, c, dh, dh // 2)))
    return cases


def _tune_inputs(dev, g, b, h, c, dh, pos, window, frac):
    """:func:`_split_inputs` for attn_tune, with a fresh row that matters as
    well: k_new lies along q (score 13, beside the oldest attended row's 14)
    and v_new is of spread 1.5, so a result without the fresh row fails the
    bar too.  Returns the 4-D operands and the oldest attended row."""
    import math

    import torch

    args, oldest = _split_inputs(dev, g, b, h, c, dh, pos, window, frac)
    qf = args[0].float()
    k_new = (qf * (13.0 * math.sqrt(dh) / (qf * qf).sum(-1, keepdim=True))).bfloat16()
    v_new = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 1.5).bfloat16()
    return (*args[:5], k_new, v_new, args[7]), oldest


def _tune_cases(dev, g):
    """attn_tune at the stt-1b rings, (64,16,768,128), at a short, a full and
    a wrapped ring position, on inputs whose outputs are O(1): each variant
    against its plain version; the ``bb`` variants bit-identical to each
    other; the int8-dot variants within ``attn_tune.I8_FROM_BF16`` of the bf16
    result (as a share of its largest output); ``bb=1`` against ``decode_attend`` on the
    same ring.  The bar must see a wrong mask in every variant: the committed
    row w let in, the oldest attended row dropped, every ring row let in and
    the fresh row dropped (each through the independent masked attention,
    held against the variant's plain version)."""
    import torch

    from dsm_tpu_torch.ops import attention as A
    from dsm_tpu_torch.ops import attn_tune as AT
    from dsm_tpu_torch.ops import decode_attn as DA

    b, h, c, dh, window = 64, 16, 768, 128, 750
    i8_bar = AT.I8_FROM_BF16
    cases = []
    for pos, frac in ((40, 0.9), (767, 1.0), (3000, 0.9)):
        args4, oldest = _tune_inputs(dev, g, b, h, c, dh, pos, window, frac)
        valid = args4[7]
        args = (*(x[:, :, 0].contiguous() for x in args4[:1]), *args4[1:5],
                *(x[:, :, 0].contiguous() for x in args4[5:7]), valid, pos, window)
        ok = _true_mask(valid, pos, c, window)
        n_rows = int(ok.sum())
        seen = {}
        for label, kw in TUNE_VARIANTS.items():

            def run_k(args=args, kw=kw):
                return (AT.attn_tune(*args, **kw),)

            def run_p(args=args, kw=kw):
                return (AT.attn_tune_plain(*args, **kw),)

            def cmp(got, want, label=label, kw=kw, args=args, args4=args4, ok=ok, pos=pos,
                    oldest=oldest, seen=seen):
                err = _close(f"attn_tune {label}", got[0], want[0])
                seen[label] = got[0]
                base = seen["bb=1"]
                top = float(base.float().abs().max())
                check(top > 0.3, f"attn_tune {label}: outputs of at most {top!r} are not O(1)")
                if not (kw.get("i8s") or kw.get("i8p")):
                    check(torch.equal(got[0], base), f"attn_tune {label} differs from bb=1")
                far = float((got[0].float() - base.float()).abs().max())
                check(far <= i8_bar * top,
                      f"attn_tune {label} is {far!r} from the bf16 variant")
                wrong = {"the committed row w let in": (ok.clone(), True),
                         "the oldest attended row dropped": (ok.clone(), True),
                         "every ring row let in": (torch.ones_like(ok), True),
                         "the fresh row dropped": (ok, False)}
                wrong["the committed row w let in"][0][:, pos % c] = True
                wrong["the oldest attended row dropped"][0][:, oldest] = False
                for what, (mask, fresh) in wrong.items():
                    check(not _within(_attend_with_mask(*args4[:7], mask, fresh), want[0]),
                          f"attn_tune {label}: the bar does not see {what}")
                if label == "bb=1":
                    check(_within(_attend_with_mask(*args4[:7], ok), want[0]),
                          "attn_tune: the plain version is outside the bar of an "
                          "independent masked attention")
                    plan = A.global_ring_plan(pos, c, 1, device=dev)
                    split = DA.decode_attend(*args4[:7], plan, args4[7], window=window)
                    check(_within(got[0], split[:, :, 0]), "attn_tune bb=1 outside the bar "
                          "of decode_attend on the same ring")
                return err

            info = dict(_attend_info(n_rows, b, h, c, dh),
                        bar=f"atol=rtol={ATOL} of its plain version; bb variants identical; "
                            f"int8 dots within {i8_bar} of the bf16 variant")
            cases.append(("attn_tune", f"pos={pos} valid={frac} {label}", run_k, run_p, cmp,
                          info))
    return cases


def _commit_q_cases(dev, g, tag, b, h, c, dh, ws, packed4=False):
    """ring_commit_q at rows ``ws`` of one set of four rings: the kernel's
    set and the plain version's set bit for bit, and every row but the
    written ones as it was.  ``packed4``: uint8 rings and rows of Dh/2
    bytes."""
    import torch

    from dsm_tpu_torch.ops import ring_kernels as RK

    row_bytes = dh // 2 if packed4 else dh

    def rows(n):
        if packed4:
            return torch.randint(0, 256, (b, h, n, row_bytes), generator=g, device=dev,
                                 dtype=torch.uint8)
        return torch.randint(-127, 128, (b, h, n, row_bytes), generator=g, device=dev,
                             dtype=torch.int8)

    def ring(dtype_int8):
        if dtype_int8:
            return rows(c)
        return torch.rand(b, h, c, generator=g, device=dev)

    orig = [ring(True), ring(True), ring(False), ring(False)]
    kern = [x.clone() for x in orig]
    plain = [x.clone() for x in orig]
    written = []
    cases = []
    for w in ws:
        kn, vn = rows(1), rows(1)
        ksn, vsn = (torch.rand(b, h, 1, generator=g, device=dev) for _ in range(2))
        news = (kn, vn, ksn, vsn)
        pos = _tick(w + 2 * c, dev)  # read on the card, modulo C

        def run_k(news=news, pos=pos):
            RK.ring_commit(kern[0], kern[1], news[0], news[1], pos, kern[2], kern[3],
                           news[2], news[3])
            return tuple(kern)

        def run_p(news=news, w=w):
            RK.ring_commit_q_plain(*plain, *news, w)
            return tuple(plain)

        def cmp(got, want, news=news, w=w):
            _exact(got, want)
            written.append(w)
            keep = torch.ones(c, dtype=torch.bool, device=dev)
            keep[written] = False
            for ring_k, ring_0, new in zip(got, orig, news):
                check(torch.equal(ring_k[:, :, w], new[:, :, 0]),
                      "ring_commit_q: the row at w is not the new row")
                check(torch.equal(ring_k[:, :, keep], ring_0[:, :, keep]),
                      "ring_commit_q touched a row it was not given")
            return 0.0

        cases.append(("ring_commit_q", f"{tag} w={w}", run_k, run_p, cmp,
                      _commit_info(kern, news, w)))
    return cases


def _miss_amaxes(qmax, n, seed):
    """``n`` bf16 amaxes in [0.5, 4) where ``amax * fl(1/qmax)`` and ``amax /
    qmax`` differ in f32 (a few dozen such values, repeated): a scale taken
    by the reciprocal fails a bit-for-bit check on each row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 4.0, 200_000).astype(np.float32)).bfloat16()
    a = a.float().numpy()
    a = rng.permutation(np.unique(a[a * np.float32(1.0 / qmax) != a / np.float32(qmax)]))
    check(len(a) >= 8, "too few amaxes that a reciprocal misses")
    return np.resize(a, n)


def _fresh_rows(dev, g, b, h, dh, qmax, seed):
    """The step's fresh K and V rows ``(B, H, 1, Dh)`` bf16: K contiguous (as
    after the rotary embedding), V a strided view of a QKV product ``(B, 1, 3,
    H, Dh)`` as ``transformer._qkv`` gives it.  Unit spread, each row's amax
    one of :func:`_miss_amaxes` at a random place and sign; in each of K and V
    a row of ties (amax ``qmax``: scale 1, values k + 0.5), a row of +-amax
    and an all-zero row."""
    import torch

    rows = []
    for i in range(2):
        amax = torch.from_numpy(_miss_amaxes(qmax, b * h, seed + i)).to(dev)
        x = (torch.rand(b * h, dh, generator=g, device=dev) - 0.5) * 0.9 * amax[:, None]
        at = torch.randint(0, dh, (b * h,), generator=g, device=dev)
        sign = torch.randint(0, 2, (b * h,), generator=g, device=dev) * 2.0 - 1.0
        x[torch.arange(b * h, device=dev), at] = amax * sign
        x[0] = 0.0
        x[1] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -3.5], device=dev).repeat(dh)[:dh]
        x[1, 5] = qmax
        x[2, ::2], x[2, 1::2] = amax[2], -amax[2]
        rows.append(x.reshape(b, h, dh).bfloat16())
    qkv = torch.zeros(b, 1, 3, h, dh, dtype=torch.bfloat16, device=dev)
    qkv[:, 0, 2] = rows[1]
    v = qkv[:, :, 2].transpose(1, 2)
    check(not v.is_contiguous(), "the V rows are not a strided view")
    return rows[0][:, :, None].contiguous(), v


def _eager_chain(k, v, qmax):
    """The parent's eager quantisation of the fresh rows, as
    ``transformer.step`` ran it before the commit: 9 device operations a
    tensor (``pack4``'s 5 more a packed one), the scale divided by a Python
    number."""
    import torch

    from dsm_tpu_torch.ops import attention as A

    def one(x):
        xf = x.float()
        scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / qmax
        q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
        return (A.pack4(q) if qmax == 7.0 else q.to(torch.int8)), scale

    (kq, ks), (vq, vs) = one(k), one(v)
    return kq, vq, ks, vs


def _quantize_commit_cases(dev, g, tag, b, h, c, dh, ws, packed4=False, scales_only=False):
    """quantize_commit (or, ``scales_only``, quantize_scale_commit) at rows
    ``ws`` of one set of rings: the kernel's set (and returned rows) and the
    plain version's bit for bit, and every row but the written ones as it
    was.  ``packed4``: uint8 rings of Dh/2 bytes a row.  The library entry is
    the eager chain the parent ran on the same rows: :func:`_eager_chain`,
    then the copy kernel (ring_commit_q or scale_commit)."""
    import torch

    from dsm_tpu_torch.ops import ring_kernels as RK

    qmax = 7.0 if packed4 else 127.0
    row_bytes = dh // 2 if packed4 else dh
    k, v = _fresh_rows(dev, g, b, h, dh, qmax, seed=c + dh + int(packed4))
    lo, hi, dt = (0, 256, torch.uint8) if packed4 else (-127, 128, torch.int8)
    orig = [torch.randint(lo, hi, (b, h, c, row_bytes), generator=g, device=dev, dtype=dt)
            for _ in range(2)] + [torch.rand(b, h, c, generator=g, device=dev) for _ in range(2)]
    if scales_only:
        orig = orig[2:]
    kern = [x.clone() for x in orig]
    plain = [x.clone() for x in orig]
    name = "quantize_scale_commit" if scales_only else "quantize_commit"
    written = []
    cases = []
    for w in ws:
        pos = _tick(w + 2 * c, dev)  # read on the card, modulo C
        if scales_only:
            def run_k(pos=pos):
                return (*RK.quantize_scale_commit(k, v, *kern, pos), *kern)

            def run_p(w=w):
                return (*RK.quantize_scale_commit_plain(k, v, *plain, w), *plain)

            def library(pos=pos):
                kq, vq, ks, vs = _eager_chain(k, v, qmax)
                RK.scale_commit(kern[0], kern[1], ks, vs, pos)
                return kq, vq
        else:
            def run_k(pos=pos):
                RK.quantize_commit(k, v, *kern, pos)
                return tuple(kern)

            def run_p(w=w):
                RK.quantize_commit_plain(k, v, *plain, w)
                return tuple(plain)

            def library(pos=pos):
                kq, vq, ks, vs = _eager_chain(k, v, qmax)
                RK.ring_commit(kern[0], kern[1], kq, vq, pos, kern[2], kern[3], ks, vs)

        def cmp(got, want, w=w):
            _exact(got, want)
            written.append(w)
            keep = torch.ones(c, dtype=torch.bool, device=dev)
            keep[written] = False
            for ring_k, ring_0 in zip(got[-len(orig):], orig):
                check(torch.equal(ring_k[:, :, keep], ring_0[:, :, keep]),
                      f"{name} touched a row it was not given")
            return 0.0

        n_rows = 2 * b * h
        info = {"bytes": n_rows * (2 * dh + row_bytes + 4), "flops": n_rows * 6 * dh,
                "library": library}
        label = f"{tag} {'uint8' if packed4 else 'int8'} w={w}"
        cases.append((name, label, run_k, run_p, cmp, info))
    return cases


def _eager_rope(x, cos, sin):
    """The parent's eager ``attention.apply_rope``: a float cast, four
    products, a difference, a sum, a stack and a cast back, each product
    rounded apart (8 device operations a tensor)."""
    import torch

    b, h, t, d = x.shape
    xf = x.float().reshape(b, h, t, d // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(
        b, h, t, d).to(x.dtype)


def _qkv_rows(dev, g, b, h, t, dh, pos):
    """The step's q, k and v ``(B, H, T, Dh)`` bf16 as strided views of one
    QKV product ``(B, T, 3, H, Dh)`` (``transformer._qkv``), and cos, sin
    ``(1, T, Dh/2)`` of positions ``pos ..``."""
    import torch

    from dsm_tpu_torch.ops import attention as A

    qkv = (torch.randn(b, t, 3, h, dh, generator=g, device=dev) * 2).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    # (One row of one batch, as cli gen's step gives it, is a contiguous view.)
    check(b * t == 1 or not any(x.is_contiguous() for x in (q, k, v)),
          "the rows are not strided views")
    cos, sin = A.rope_cos_sin(torch.arange(t, device=dev)[None] + pos, dh, 10_000.0)
    return q, k, v, cos, sin


def _rope_info(q, cos, rings, library):
    """q and k rotated, v copied: each of q, k, v read once, cos and sin
    read once, the rotated q and k written and, with rings, the k and v ring
    rows written; two products and two fused multiply-adds a rotary pair of
    q and of k (6 operations)."""
    row_bytes = q.numel() * q.element_size()
    n_bytes = ((3 if rings else 2) * row_bytes + 2 * cos.numel() * 4 + 2 * row_bytes
               + (2 * q.numel() * rings[0].element_size() if rings else 0))
    return {"bytes": n_bytes, "flops": 2 * (q.numel() // 2) * 6, "library": library}


def _rope_commit_cases(dev, g, tag, b, h, c, t, dh, ws):
    """rope_commit at rows ``ws`` of one pair of bf16 rings: the kernel's
    rotated q, k and rings and the plain version's bit for bit, every row
    but the written ones as it was.  The library entry is the chain the
    parent ran on the same rows: its eager rope of q and of k, then
    ring_commit (which made V contiguous first)."""
    import torch

    from dsm_tpu_torch.ops import ring_kernels as RK

    orig = [torch.randn(b, h, c, dh, generator=g, device=dev).bfloat16() for _ in range(2)]
    kern = [x.clone() for x in orig]
    plain = [x.clone() for x in orig]
    cases, written = [], []
    for w in ws:
        q, k, v, cos, sin = _qkv_rows(dev, g, b, h, t, dh, 3000 + w)
        pos = _tick(w + 2 * c, dev)  # read on the card, modulo C

        def run_k(q=q, k=k, v=v, cos=cos, sin=sin, pos=pos):
            return (*RK.rope_commit(q, k, v, *kern, cos, sin, pos), *kern)

        def run_p(q=q, k=k, v=v, cos=cos, sin=sin, w=w):
            return (*RK.rope_commit_plain(q, k, v, *plain, cos, sin, w), *plain)

        def library(q=q, k=k, v=v, cos=cos, sin=sin, pos=pos):
            qr, kr = _eager_rope(q, cos, sin), _eager_rope(k, cos, sin)
            RK.ring_commit(kern[0], kern[1], kr, v, pos)
            return qr, kr

        def cmp(got, want, w=w):
            _exact(got, want)
            written.extend(range(w, w + t))
            keep = torch.ones(c, dtype=torch.bool, device=dev)
            keep[written] = False
            for ring_k, ring_0 in zip(got[2:], orig):
                check(torch.equal(ring_k[:, :, keep], ring_0[:, :, keep]),
                      "rope_commit touched a row it was not given")
            return 0.0

        cases.append(("rope_commit", f"{tag} w={w}", run_k, run_p, cmp,
                      _rope_info(q, cos, kern, library)))
    return cases


def _rope_qk_case(dev, g, tag, b, h, dh, pos):
    """rope_qk at an LM's fresh rows: bit for bit its plain version; the
    library entry is the parent's eager rope of q and of k."""
    from dsm_tpu_torch.ops import ring_kernels as RK

    q, k, _, cos, sin = _qkv_rows(dev, g, b, h, 1, dh, pos)
    return ("rope_qk", f"{tag} ({b},{h},1,{dh})", lambda: RK.rope_qk(q, k, cos, sin),
            lambda: RK.rope_qk_plain(q, k, cos, sin), _exact,
            _rope_info(q, cos, None, lambda: (_eager_rope(q, cos, sin),
                                              _eager_rope(k, cos, sin))))


def kernel_cases(dev):
    """Inputs at the serving paths' shapes, from a seeded generator; each
    case is (name, label, run_kernel, run_plain, compare).  Each run returns
    its outputs (and the rings it wrote), which compare checks."""
    import torch

    from dsm_tpu_torch.ops import ring_kernels as RK

    g = torch.Generator(device=dev).manual_seed(1234)
    cases = []

    # STT: the LM's scale rings (C=768) and the Mimi encoder's bf16 ring.
    ks = torch.rand(64, 16, 768, generator=g, device=dev)
    vs = torch.rand(64, 16, 768, generator=g, device=dev)
    ksn = torch.rand(64, 16, 1, generator=g, device=dev)
    vsn = torch.rand(64, 16, 1, generator=g, device=dev)
    for w in (0, 5, 767):
        cases.append(_commit_case("scale_commit", f"stt w={w}", RK.scale_commit,
                                  RK.scale_commit_plain, ks, vs, ksn, vsn, w))
    kc = torch.randn(64, 8, 256, 64, generator=g, device=dev).bfloat16()
    vc = torch.randn(64, 8, 256, 64, generator=g, device=dev).bfloat16()
    kn = torch.randn(64, 8, 2, 64, generator=g, device=dev).bfloat16()
    vn = torch.randn(64, 8, 2, 64, generator=g, device=dev).bfloat16()
    for w in (0, 40, 254):
        cases.append(_commit_case("ring_commit", f"w={w}", RK.ring_commit,
                                  RK.ring_commit_plain, kc, vc, kn, vn, w))
    cases += _ring_backward_cases(dev, g)
    # Duplex: the same codec rings at B=24, in the encoder and the decoder
    # (phase_duplex checks the engine's rings have this shape).
    kc, vc, kn, vn = (torch.randn(*DUPLEX_MIMI_RING[:2], rows, DUPLEX_MIMI_RING[3],
                                  generator=g, device=dev).bfloat16()
                      for rows in (DUPLEX_MIMI_RING[2],) * 2 + (2, 2))
    for w in (0, 254):
        cases.append(_commit_case("ring_commit", f"duplex B=24 w={w}", RK.ring_commit,
                                  RK.ring_commit_plain, kc, vc, kn, vn, w))
    # The step's path for the codec's rings: the rope folded into the commit
    # (T=2 rows a step, q, k and v strided), at the STT/TTS and duplex batch;
    # then the rope alone before the LM's int8 commits, at the fresh rows of
    # stt-1b / tts-1.6b, stt-2.6b / tts_202501 and s2s-2b.
    cases += _rope_commit_cases(dev, g, "stt", 64, 8, 256, 2, 64, (0, 128, 254))
    cases += _rope_commit_cases(dev, g, "duplex B=24", *DUPLEX_MIMI_RING[:3], 2,
                                DUPLEX_MIMI_RING[3], (0, 254))
    for tag, (b, h, dh) in (("stt1b", (64, 16, 128)), ("stt26", (64, 32, 64)),
                            ("duplex", (24, 20, 128)), ("moshi", MOSHI_RING[:2] + (128,))):
        cases.append(_rope_qk_case(dev, g, tag, b, h, dh, 100_000))
    cases += _attend_cases(dev, g, "stt", 64, 16, 768, 128, 750, False,
                           ((0, 1.0), (40, 0.9), (767, 0.6), (3000, 1.0)), timed=(3000,))

    # TTS: the LM's rings hold C = window = context = 1024 rows; the Mimi
    # decoder's bf16 ring is the encoder's shape above.
    ks = torch.rand(64, 16, 1024, generator=g, device=dev)
    vs = torch.rand(64, 16, 1024, generator=g, device=dev)
    for w in (0, 1023):
        cases.append(_commit_case("scale_commit", f"tts w={w}", RK.scale_commit,
                                  RK.scale_commit_plain, ks, vs, ksn, vsn, w))
    cases += _attend_cases(dev, g, "tts", 64, 16, 1024, 128, 1024, True,
                           ((1023, 1.0), (2048, 0.7), (5000, 0.7)), timed=(5000,))
    cases += _ca_cases(dev, g)

    # Duplex: s2s-2b's rings (20 heads x 3072 rows of 128: the split
    # pipeline), a ring that holds garbage at pos 0, fills, and wraps; and
    # the other shape family of the split, Dh = 64 with window = C.
    cases += _commit_q_cases(dev, g, "duplex", 24, 20, 3072, 128, (0, 1500, 3071))
    cases += _commit_q_cases(dev, g, "B=64 H=32 C=384 Dh=64", 64, 32, 384, 64, (100,))
    cases += _split_cases(dev, g, "duplex", 24, 20, 3072, 128, 3000,
                          ((0, 1.0), (40, 0.7), (3071, 1.0), (5000, 0.7), (10000, 1.0)))
    cases += _split_cases(dev, g, "B=2 H=32 C=4096 Dh=64", 2, 32, 4096, 64, 4096,
                          ((4200, 0.9),))
    # Moshi 7B in the dialogue layout (build_duplex's default model): 32 heads
    # x 128 over a 3,072-row ring, the split pipeline, at a served ring, a full
    # one and a wrapped one.
    cases += _quantize_commit_cases(dev, g, "moshi", *MOSHI_RING, (0, 1536, 3071))
    cases += _split_cases(dev, g, "moshi", *MOSHI_RING, 3000,
                          ((40, 0.7), (3071, 1.0), (10000, 1.0)))
    # The bf16 LM rings of cli gen (Moshi 7B, B=1) and of the legacy TTS
    # (tts_v0_1, the two guidance rows): one bf16 row a step, at the first,
    # a middle and the last row.
    for tag, (b, h, c, dh) in (("gen moshi", GEN_RING), ("tts_v0_1", LEGACY_RING)):
        cases += _rope_commit_cases(dev, g, tag, b, h, c, 1, dh, (0, c // 2, c - 1))

    # stt-2.6b: 32 heads x 64 over a 384-row ring, window 375: an empty, a
    # part-filled, a full and a wrapped ring, through decode_attend (one
    # span) and through the fused commit; then decode_attend at the stt-1b
    # rings, the split route of the shapes the fused kernel serves.
    stt26_pos = ((0, 1.0), (40, 0.7), (383, 1.0), (3000, 1.0))
    cases += _split_cases(dev, g, "stt26", 64, 32, 384, 64, 375, stt26_pos)
    # tts_202501's rings (32 heads x 64 over 512 rows, window 500): the same
    # head-major route, nearly empty and wrapped.
    cases += _split_cases(dev, g, "tts202501", 64, 32, 512, 64, 500, ((40, 0.9), (3000, 1.0)))
    cases += _attend_cases(dev, g, "stt26", 64, 32, 384, 64, 375, True, stt26_pos,
                           timed=(3000,))
    cases += _split_cases(dev, g, "stt1b", 64, 16, 768, 128, 750, ((40, 0.9), (3000, 1.0)))
    cases += _qmm_cases(dev, g)

    # Packed-int4 rings (kv_bits = 4): the stt-1b, stt-2.6b and s2s-2b rings at
    # half their bytes, at a short, a full and a wrapped ring position; the
    # commit of uint8 rows; then the tuning tool's kernel.
    cases += _commit_q_cases(dev, g, "stt1b-kv4 uint8", 64, 16, 768, 128, (0, 767), True)
    cases += _commit_q_cases(dev, g, "stt26-kv4 uint8", 64, 32, 384, 64, (100,), True)
    cases += _commit_q_cases(dev, g, "duplex-kv4 uint8", 24, 20, 3072, 128, (1500,), True)
    cases += _split_cases_q4(dev, g, "stt1b-kv4", 64, 16, 768, 128, 750,
                             ((40, 0.9), (767, 1.0), (3000, 1.0)))
    cases += _split_cases_q4(dev, g, "stt26-kv4", 64, 32, 384, 64, 375,
                             ((0, 1.0), (383, 1.0), (3000, 1.0)))
    cases += _split_cases_q4(dev, g, "duplex-kv4", 24, 20, 3072, 128, 3000,
                             ((40, 0.7), (3071, 1.0), (10000, 1.0)))
    cases += _tune_cases(dev, g)

    # The step's quantise-and-commit (TPU kernels 4 and 1 on the path): the
    # split route's int8 and packed-int4 rings of stt-1b (fused_attn = False),
    # stt-2.6b and tts_202501, and s2s-2b; the fused route's rings of stt-1b,
    # tts-1.6b and stt-2.6b (fused_attn = True), and the s2s-2b width.
    for packed4 in (False, True):
        for tag, (b, h, c, dh) in (("stt1b", (64, 16, 768, 128)), ("stt26", (64, 32, 384, 64)),
                                   ("duplex", (24, 20, 3072, 128))):
            cases += _quantize_commit_cases(dev, g, tag, b, h, c, dh, (0, c // 2, c - 1),
                                            packed4)
    for tag, (b, h, c, dh) in (("stt1b", (64, 16, 768, 128)), ("tts", (64, 16, 1024, 128)),
                               ("stt26", (64, 32, 384, 64)), ("duplex", (24, 20, 3072, 128))):
        cases += _quantize_commit_cases(dev, g, tag, b, h, c, dh, (0, c // 2, c - 1),
                                        scales_only=True)
    return cases + mesh_kernel_cases(dev, g)


def mesh_kernel_cases(dev, g):
    """The kernels at the shapes one shard of the mesh phases gives them
    (labels start with "mesh"): dp = 2 halves the batch, tp = 2 the heads.
    stt-1b at (32,16) and (32,8) heads through the fused route, and at
    (32,4), tp = 4's local heads, which fall outside the fused rule, through
    decode_attend; tts-1.6b's (32,8) rings and its voice store at 8 heads;
    s2s-2b's (12,10) rings through the split route; the codec rings of a
    shard; rope_qk at each shard's LM rows."""
    cases = []
    for tag, h in (("mesh stt1b dp", 16), ("mesh stt1b tp", 8)):
        cases += _quantize_commit_cases(dev, g, tag, 32, h, 768, 128, (0, 767), scales_only=True)
        cases += _attend_cases(dev, g, tag, 32, h, 768, 128, 750, False,
                               ((40, 0.9), (3000, 1.0)))
        cases.append(_rope_qk_case(dev, g, tag, 32, h, 128, 100_000))
    cases += _split_cases(dev, g, "mesh stt1b tp4", 32, 4, 768, 128, 750, ((40, 0.9), (3000, 1.0)))
    cases += _quantize_commit_cases(dev, g, "mesh tts tp", 32, 8, 1024, 128, (0, 1023),
                                    scales_only=True)
    cases += _attend_cases(dev, g, "mesh tts tp", 32, 8, 1024, 128, 1024, True,
                           ((1023, 1.0), (5000, 0.7)))
    cases += _ca_cases(dev, g, ((32, 8, 640, 625, 128),), "mesh tts tp ")
    cases += _quantize_commit_cases(dev, g, "mesh duplex tp", 12, 10, 3072, 128, (0, 3071))
    cases += _split_cases(dev, g, "mesh duplex tp", 12, 10, 3072, 128, 3000,
                          ((40, 0.7), (5000, 0.7)))
    cases.append(_rope_qk_case(dev, g, "mesh duplex tp", 12, 10, 128, 100_000))
    for tag, b in (("mesh stt/tts", 32), ("mesh duplex", 12)):
        cases += _rope_commit_cases(dev, g, tag, b, 8, 256, 2, 64, (0, 254))
    return cases


def _qmm_within(a, p) -> bool:
    """Every element within one bf16 step of the plain result or 1e-2, and
    QMM_REL_L2 overall: kernel and plain version sum the same exact products
    in f32 in other orders and round once."""
    import torch

    a, p = a.float(), p.float()
    step = torch.exp2(torch.floor(torch.log2(p.abs().clamp_min(1e-30))) - 7)
    near = (a - p).abs() <= step.clamp_min(1e-2)
    return bool(near.all()) and float((a - p).norm() / p.norm()) <= QMM_REL_L2


def _qmm_cases(dev, g):
    """qmm at QMM_SHAPES, tiled as the wrapper picks: activations of unit
    spread, int8 weights, scales that make the outputs O(1).  The bar must
    see one output channel's scale dropped and one 64-wide piece of K dropped
    (plain version).  ``cold``: the inputs that ``_qmm_times`` times over
    copies of the weight."""
    import torch

    from dsm_tpu_torch.ops import qmm as QM

    cases = []
    for m, o, i in QMM_SHAPES:
        x = torch.randn(m, i, generator=g, device=dev).bfloat16()
        wq = torch.randint(-127, 128, (o, i), generator=g, device=dev, dtype=torch.int8)
        sc = (torch.rand(o, generator=g, device=dev) + 0.5) / (73.3 * i ** 0.5)

        def run_k(x=x, wq=wq, sc=sc):
            return (QM.qmm(x, wq, sc),)

        def run_p(x=x, wq=wq, sc=sc):
            return (QM.qmm_plain(x, wq, sc),)

        def cmp(got, want, x=x, wq=wq, sc=sc, o=o, i=i):
            check(bool(torch.isfinite(got[0]).all()), "qmm output not finite")
            check(_qmm_within(got[0], want[0]), "qmm outside one bf16 step of its plain version")
            s_bad, x_bad = sc.clone(), x.clone()
            s_bad[o // 3] = 1.0
            x_bad[:, i - 128:i - 64] = 0
            check(not _qmm_within(QM.qmm_plain(x, wq, s_bad), want[0]),
                  "qmm: the bar does not see a dropped scale")
            check(not _qmm_within(QM.qmm_plain(x_bad, wq, sc), want[0]),
                  "qmm: the bar does not see a dropped piece of K")
            return float((got[0].float() - want[0].float()).abs().max())

        info = {"bytes": o * i + 2 * m * i + 4 * o + 2 * m * o, "flops": 2 * m * o * i,
                "peak": BF16_TENSOR_FLOPS, "library": None, "cold": (x, wq, sc),
                "bar": f"one bf16 step or 1e-2 per element, relative L2 {QMM_REL_L2}"}
        cases.append(("qmm", f"M={m} O={o} I={i}", run_k, run_p, cmp, info))
    return cases


def _ca_inputs(g, dev, b, h, s_pad, s_len, dh):
    """A voice source with O(1) outputs whose last real row matches the
    query best (score 14 against a spread of about 3.7) and whose padding
    rows would match it better still (score 26, values 127 at scale 1):
    dropping the last row or reading a padding row fails the bar."""
    import math

    import torch

    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    k, v = (torch.randint(-127, 128, (b, h, s_pad, dh), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = _sharp_scales(g, dev, b, h, s_pad)
    qf = q[:, :, 0].float()
    aligned = torch.where(qf >= 0, 127, -127).to(torch.int8)
    per_scale = 127.0 * qf.abs().sum(-1) / math.sqrt(dh)  # score per unit k_scale
    k[:, :, s_len - 1] = aligned
    ks[:, :, s_len - 1] = 14.0 / per_scale
    k[:, :, s_len:] = aligned[:, :, None]
    ks[:, :, s_len:] = (26.0 / per_scale)[..., None]
    v[:, :, s_len:] = 127
    vs[:, :, s_len:] = 1.0
    return q, k, v, ks, vs


CA_SHAPES = ((64, 16, 256, 200, 128), (64, 32, 640, 625, 64), (64, 16, 128, 1, 128),
             (64, 16, 640, 625, 128), (1, 16, 640, 625, 128))
CA_TIMES = {}  # label -> the cluster size, device ms, bound ms and share of each CA case


def _ca_cases(dev, g, shapes=CA_SHAPES, tag=""):
    """The TTS voice cross-attention: a partial source, the Dh=64 head
    shape, one real row, the serving shape (B=64, H=16, 5 speakers x 125
    rows -> 640), then one session; ``shapes`` (B, H, rows padded, rows, Dh)
    and a label prefix for others.  Each at the cluster size the wrapper
    picks for this card (``info["cluster"]``)."""
    from dsm_tpu_torch.ops import decode_attn as DA

    cases = []
    for b, h, s_pad, s_len, dh in shapes:
        q, k, v, ks, vs = _ca_inputs(g, dev, b, h, s_pad, s_len, dh)

        def run_k(q=q, k=k, v=v, ks=ks, vs=vs, s_len=s_len):
            return (DA.ca_decode_attend(q, k, v, ks, vs, s_len)[:, :, 0],)

        def run_p(q=q, k=k, v=v, ks=ks, vs=vs, s_len=s_len):
            return (DA.ca_decode_attend_plain(q[:, :, 0], k, v, ks, vs, s_len),)

        def cmp(got, want, q=q, k=k, v=v, ks=ks, vs=vs, s_len=s_len, s_pad=s_pad):
            err = _close("ca_decode_attend", got[0], want[0])
            for n, what in ((s_len - 1, "a dropped last row"),
                            (s_len + 1, "a padding row read")):
                if 1 <= n <= s_pad:
                    alt = DA.ca_decode_attend_plain(q[:, :, 0], k, v, ks, vs, n)
                    check(not _within(alt, want[0]),
                          f"ca_decode_attend: the bar does not see {what}")
            return err

        info = {"bytes": b * h * s_len * (2 * dh + 8) + 2 * b * h * dh * 2,
                "flops": b * h * s_len * 4 * dh, "library": None,
                "cluster": DA.pick_ca_cluster(b * h, s_len, dh, DA.card_sms(dev.index or 0))}
        cases.append(("ca_decode_attend", f"{tag}B={b} H={h} S={s_len}/{s_pad} Dh={dh}",
                      run_k, run_p, cmp, info))
    return cases


OPUS_MIN_CORR = 0.95  # tests/test_opus.py's bar for the decoded stream
OPUS_PASSES = 5  # encoder and decoder runs over the sample, for the medians


def phase_opus(card):
    """The Opus wire's codec on this machine: whether libopus and libogg load,
    and where they do the speech sample encoded and decoded in 80 ms frames
    (the frame the routes encode), held to OPUS_MIN_CORR; host ms a frame."""
    import ctypes
    import ctypes.util

    import numpy as np

    from dsm_tpu_torch.utils import opus
    from dsm_tpu_torch.utils.audio import decode_audio

    libs = []
    for name in ("opus", "ogg"):
        path = ctypes.util.find_library(name)
        try:
            state = f"loads ({path})" if path and ctypes.CDLL(path) else "not found"
        except OSError as e:
            state = f"found ({path}) but does not load: {e}"
        libs.append(f"lib{name} {state}")
    if not opus.available():
        print(f"[opus] {'; '.join(libs)}: the Opus wire is not available on this machine "
              f"(its routes fall back to pcm or refuse, as the JAX package's do; a missing host "
              f"library, not a device path); card {card}", flush=True)
        return
    pcm = decode_audio(os.path.join(ROOT, "audio", "speech-synthetic.wav"))
    frame = 1920
    n = -(-len(pcm) // frame) * frame
    pcm = np.pad(pcm, (0, n - len(pcm)))
    enc_ms, dec_ms = [], []
    for _ in range(OPUS_PASSES):
        enc, dec = opus.OggOpusEncoder(), opus.OggOpusDecoder()
        outs = []
        for i in range(0, n, frame):
            t0 = time.perf_counter()
            data = enc.encode(pcm[i:i + frame], eos=i + frame >= n)
            t1 = time.perf_counter()
            outs.append(dec.decode(data))
            t2 = time.perf_counter()
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
        out = np.concatenate(outs)
        check(out.shape == pcm.shape and np.isfinite(out).all(),
              f"[opus] {len(out)} samples decoded for {len(pcm)} encoded")
    m = len(pcm) - 600
    corr, shift = max((float(np.corrcoef(pcm[:m], out[s:s + m])[0, 1]), s)
                      for s in range(0, 600, 4))
    check(corr > OPUS_MIN_CORR, f"[opus] correlation {corr!r} at the best shift, bar "
          f"{OPUS_MIN_CORR}")
    print(f"[opus] {'; '.join(libs)}: audio/speech-synthetic.wav ({len(pcm) / 24_000.0:.3f} s, "
          f"{n // frame} frames of 80 ms) through dsm_tpu_torch.utils.opus, "
          f"{OPUS_PASSES} passes: one sample out for each in; correlation {corr!r} at a "
          f"{shift}-sample shift (bar {OPUS_MIN_CORR}); host ms a frame median "
          f"{float(np.median(enc_ms))!r} to encode, {float(np.median(dec_ms))!r} to decode "
          f"(max {max(enc_ms)!r} / {max(dec_ms)!r}); card {card}", flush=True)


def phase_kernels(dev):
    """Each case: the kernel REPEATS times (its results bit-identical: the
    kernels have no atomics and a fixed summation order), then its plain
    version; outputs within the bar, rings bit for bit.  Returns each
    case's max error by (kernel, label)."""
    import torch

    errs = {}
    for name, label, run_k, run_p, cmp, info in kernel_cases(dev):
        runs = [tuple(t.clone() for t in run_k()) for _ in range(REPEATS)]
        want = run_p()
        torch.cuda.synchronize()
        for again in runs[1:]:
            check(all(torch.equal(a, b) for a, b in zip(runs[0], again)),
                  f"{name} {label}: repeated kernel runs differ")
        err = cmp(runs[0], want)
        errs[(name, label)] = err
        bar = info.get("bar", f"rings exact, outputs atol=rtol={ATOL}")
        print(f"[kernels] {name} {label}: max_abs_err {err!r}, max |plain| "
              f"{float(want[0].float().abs().max())!r}, {REPEATS} kernel runs identical "
              f"(bar: {bar})", flush=True)
    return errs


# ---------------------------------------------------------------------------
# Phase 4: serve through the engine
# ---------------------------------------------------------------------------


def _pcm(seed: int, seconds: float, frame: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(round(seconds * 24000 / frame)) * frame
    t = np.arange(n, dtype=np.float32) / 24000.0
    f0 = 150.0 + 40.0 * seed
    sig = 0.3 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.2 * t))
    return (sig + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _open(engine, sid, seconds, sessions, seed=None):
    import numpy as np

    events = []
    ch = engine.open_channel(events.append, seed=seed)
    check(ch is not None, "no free slot")
    frame = engine.frame_size
    pcm = _pcm(sid, seconds, frame)
    ch.push_pcm(pcm)
    engine.add_marker(ch, 1000 + sid)
    # Silence after the marker flushes it through the ASR delay.
    ch.push_pcm(np.zeros(frame * (engine.cfg.asr_delay_in_tokens + 1), np.float32))
    sessions[sid] = {"ch": ch, "events": events,
                     "frames": ch.samples_pushed // frame}
    return ch


def _drive(engine, sessions, limit_s=300.0):
    frame = engine.frame_size
    deadline = time.monotonic() + limit_s
    while any(s["ch"].buffered_samples() >= frame for s in sessions.values()):
        check(time.monotonic() < deadline, "sessions did not drain")
        engine.tick()
    engine.flush()


def _verify(sessions, sids, n_vad):
    import numpy as np

    for sid in sids:
        s = sessions[sid]
        evs = s["events"]
        steps = [e.step_idx for e in evs]
        check(steps == list(range(1, s["frames"] + 1)),
              f"session {sid}: {len(steps)} step events for {s['frames']} frames")
        markers = [m for e in evs for m in e.markers]
        check(markers == [1000 + sid], f"session {sid}: markers {markers}")
        for e in evs:
            if n_vad == 0:  # a model without semantic-VAD heads delivers none
                check(e.prs is None, f"session {sid}: prs from a model without VAD heads")
                continue
            check(e.prs is not None and e.prs.shape == (n_vad,)
                  and bool(np.isfinite(e.prs).all()), f"session {sid}: bad prs")


def phase_serve(dev):
    import torch

    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import config as CFG

    counters = {name: _duplex_counters()[name] for name in PER_STEP}
    mod = CFG.Config.load(os.path.join(ROOT, "configs", "config-stt.toml")).modules["asr"]
    t0 = time.perf_counter()
    engine = builder.build_batched_asr(mod, dev, cuda_graph=False)  # [graph]: the captured one
    tcfg = engine.cfg.lm.transformer
    check((tcfg.d_model, tcfg.num_layers, tcfg.num_heads, engine.cfg.lm.audio_codebooks,
           engine.batch_size) == (2048, 16, 16, 32, 64), "not the stt-1b B=64 config")
    check(engine.cfg.kv_quant and engine.cfg.mimi_dtype == "bfloat16", "not the serving profile")
    check(isinstance(engine.params["lm"]["transformer"][0]["in_proj_w"], dict),
          "LM weights not int8")
    torch.cuda.synchronize()
    print(f"[serve] engine built in {time.perf_counter() - t0:.3f} s "
          f"(stt-1b d=2048 L=16 K=32 B=64, int8 KV + W8A8, bf16 codec, "
          f"seeded random weights)", flush=True)
    t0 = time.perf_counter()
    engine.warmup()
    print(f"[serve] warmup {time.perf_counter() - t0:.3f} s", flush=True)

    launches = _serve_asr(engine, counters, PER_STEP, "serve")
    return engine, launches


def _serve_asr(engine, counters, per_step, tag):
    """8 sessions, then 4 more in reused slots, through a BatchedAsr engine;
    every frame answered, every marker delivered after the ASR delay, and
    exactly ``per_step`` launches of each kernel per engine step.  Returns
    the launches."""
    for fn in counters.values():
        fn.launches = 0
    steps0 = engine.step_count
    n_vad = engine.cfg.lm.extra_heads[0] if engine.cfg.lm.extra_heads else 0
    sessions = {}
    for sid in range(8):
        _open(engine, sid, 3.0 + sid / 8.0, sessions)
    # Idle connections fill the other slots, so the next sessions can only
    # land in slots freed by closed ones: the reset path.
    idle = [engine.open_channel(lambda ev: None)
            for _ in range(engine.batch_size - engine.used_slots())]
    check(engine.used_slots() == engine.batch_size, "slots left free")
    _drive(engine, sessions)
    _verify(sessions, range(8), n_vad)
    freed = {sessions[sid]["ch"].slot for sid in range(4)}
    for sid in range(4):
        engine.close_channel(sessions[sid]["ch"])
    for sid in range(8, 12):
        ch = _open(engine, sid, 1.0, sessions)
        check(ch.slot in freed, f"session {sid} did not reuse a freed slot")
    _drive(engine, {sid: sessions[sid] for sid in range(4, 12)})
    _verify(sessions, range(8, 12), n_vad)
    for ch in [sessions[sid]["ch"] for sid in range(4, 12)] + idle:
        engine.close_channel(ch)
    check(engine.used_slots() == 0, "slots still open")
    steps = engine.step_count - steps0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        check(n > 0 or per_step[name] == 0, f"{name} never launched on the main path")
        check(n == per_step[name] * steps,
              f"{name}: {n} launches over {steps} steps, want {per_step[name]} per step")
    frames = sum(s["frames"] for s in sessions.values())
    print(f"[{tag}] 12 sessions, {frames} frames, 12 markers delivered after the "
          f"{engine.cfg.asr_delay_in_tokens}-token delay, {steps} engine steps; launches "
          f"{launches} = per step {per_step}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


def phase_times(engine, dev, card, tag="", full_rings=False):
    """The engine step with every slot active (host clock), a kernel profile
    of 2 steps, and the step's two halves alone; lines tagged ``[<tag>times]``
    and ``[<tag>profile]``; with ``full_rings`` last a kernel profile of 2
    steps over the LM's rings made full and wrapped (:func:`_fill_rings`).
    Returns the step's median ms, the peak memory in GB and the profiled
    kernel ms per step (served rings)."""
    import numpy as np
    import torch

    b = engine.batch_size
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal((b, 1, engine.frame_size)) * 0.1).astype(np.float32)
    on = np.ones(b, bool)
    off = np.zeros(b, bool)
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        engine._invoke_step(pcm, on, on)  # every slot fresh
        for i in range(55):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine._invoke_step(pcm, on, off)
            torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(out["prs"]).all()), "prs not finite at B=64")
    check(int(out["step_idx"].min()) == 56, "a slot did not step every time")
    step_ms = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}times] engine step, {b} slots active: median {step_ms!r} ms, "
          f"min {min(times)!r}, max {max(times)!r} over 50 after 5 warm-up; "
          f"peak memory {peak_gb:.2f} GB; card {card}", flush=True)

    # Where the device time goes: kernel time by name over 2 steps, and the
    # device's busy share of the host's wall time for those steps.
    with torch.inference_mode():
        rows, wall_us = _profile(lambda: engine._invoke_step(pcm, on, off), 2)
    total = _print_profile(f"{tag}profile", "", rows, wall_us, 2, "step", card, 12)

    # The step's two halves alone: Mimi encode and the LM step.
    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.models import mimi as MIMI

    cfg, params, st = engine.cfg, engine.params, engine.state
    x = torch.as_tensor(pcm, device=dev).bfloat16()
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    text = torch.zeros(b, dtype=torch.int32, device=dev)
    audio = torch.zeros((b, cfg.lm.audio_codebooks), dtype=torch.int32, device=dev)
    halves = {
        "mimi_encode": lambda: MIMI.encode_step(cfg.mimi, params["mimi"],
                                                st["mimi_enc"], x, mask),
        "lm_step": lambda: LM.step(cfg.lm, params["lm"], st["lm"], text, audio, mask),
    }
    for name, fn in halves.items():
        with torch.inference_mode():
            ts = []
            for i in range(25):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 5:
                    ts.append((time.perf_counter() - t0) * 1e3)
        print(f"[{tag}times] {name}, {b} slots: median {statistics.median(ts)!r} ms, min "
              f"{min(ts)!r}, max {max(ts)!r} over 20 after 5 warm-up; card {card}", flush=True)
    if full_rings:  # where the ring attention reads most: every row of every ring
        _fill_rings(st["lm"]["t"], torch.Generator(device=dev).manual_seed(37), 3000)
        with torch.inference_mode():
            engine._invoke_step(pcm, on, off)
            rows, wall_us = _profile(lambda: engine._invoke_step(pcm, on, off), 2)
        _print_profile(f"{tag}profile", "over full rings: ", rows, wall_us, 2, "step", card, 12)
    return step_ms, peak_gb, total


def kernel_times(dev, card):
    """Each kernel case: the kernel, its plain version and, where one
    exists, the library call as device time (the tuning tool's
    ``device_time_ms``: CUDA events around calls queued behind a spin kernel), and
    its bound from this run's inputs.  Returns the headline cases' numbers
    by the name of their JSON entry."""
    from dsm_tpu_torch.tools.attn_kernel_tune import device_time_ms

    ms = {}
    wrapper_of = {**{name: name for name in SOURCES},
                  **{name: route[0] for name, route in ROUTES.items()}}
    for name, label, run_k, run_p, _cmp, info in kernel_cases(dev):
        bound_ms, bound_by = _bound(info)
        if "cold" in info:
            k_ms, p_ms, lib_ms = _qmm_times(name, label, info, bound_ms, card)
        else:
            k_ms, p_ms = device_time_ms(run_k), device_time_ms(run_p)
            check(k_ms > 0, f"{name} {label}: no device time measured")
            lib_ms = device_time_ms(info["library"]) if info["library"] else None
            cluster = f", cluster of {info['cluster']}" if "cluster" in info else ""
            print(f"[times] {name} {label}{cluster}: kernel {k_ms!r} ms, plain {p_ms!r} ms, "
                  f"bound {bound_ms!r} ms by {bound_by} ({info['bytes']} bytes, "
                  f"{info['flops']} operations; {100 * bound_ms / k_ms:.1f} % of it reached), "
                  f"library call {lib_ms!r} ms (device time, 20 calls queued behind a spin "
                  f"kernel); card {card}", flush=True)
            if "cluster" in info:
                CA_TIMES[label] = {"cluster": info["cluster"], "ms": k_ms, "bound_ms": bound_ms,
                                   "share": bound_ms / k_ms}
        for what, fn in info.get("also", {}).items():
            also_ms = device_time_ms(fn)
            print(f"[times] {name} {label}, {what}: kernel {also_ms!r} ms "
                  f"({100 * bound_ms / also_ms:.1f} % of the bound); card {card}", flush=True)
        for entry, head in HEADLINE.items():
            if wrapper_of[entry] == name and head == label:
                ms[entry] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib_ms}
    check(set(ms) == set(HEADLINE), "a headline kernel case is missing")
    return ms


def _qmm_times(name, label, info, bound_ms, card):
    """A qmm case timed as the serving step meets it: every call on another
    copy of the weight, 128 MiB of them (``qmm_variants.COLD_BYTES``: over
    twice the 50 MB L2), the weight cold, and behind a kernel that writes x
    (``qmm_variants.cold_ms``); the warm time (one weight, 20 calls) and the
    cold time back to back beside it, and the tiling with the clusters the
    card holds.  The
    library call is ``torch._weight_int8pack_mm`` (bf16 scales: a yardstick
    of time only, not held to the bar), timed cold the same way, or none
    with its error printed; the pair ``wq.to(bf16)`` + matmul + scale is an
    ``also`` line.  -> cold kernel ms, cold plain ms, cold library ms or
    None."""
    import torch

    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops import qmm as QM
    from dsm_tpu_torch.tools import qmm_variants as QV

    x, wq, sc = info["cold"]
    (m, i), o = x.shape, wq.shape[0]
    tiling = QM.qmm_tiling(m, o, i, QM.resident_clusters(x.device.index or 0))
    resident = _build.lib().dsm_qmm_max_clusters(m, o, tiling.ksplit)
    blocks = tiling.grid[0] * tiling.grid[1] * tiling.grid[2]
    print(f"[times] {name} {label}: tiling {QM.TILE_O} channels a block, K split over "
          f"clusters of {tiling.ksplit}, grid {tiling.grid} = {blocks} blocks; the card holds "
          f"{resident} such clusters ({resident * tiling.ksplit} blocks) at once", flush=True)
    copies = QV.weight_copies(wq)
    s16 = sc.to(torch.bfloat16)
    k_ms = QV.cold_ms(QM.qmm, x, copies, sc)
    warm = QV.warm_ms(QM.qmm, x, wq, sc)
    b2b = QV.cold_ms(QM.qmm, x, copies, sc, behind=False)
    check(k_ms > 0 and warm > 0, f"{name} {label}: no device time measured")
    p_ms = QV.cold_ms(QM.qmm_plain, x, copies, sc)
    try:
        lib_ms = QV.cold_ms(lambda a, w, _s: torch._weight_int8pack_mm(a, w, s16), x,
                            copies, sc)
        lib = f"{lib_ms!r} ms"
    except Exception as e:  # the yardstick is missing on this torch: reported, no figure
        lib_ms, lib = None, f"none ({type(e).__name__}: {str(e).splitlines()[0][:160]})"
    pair_ms = QV.cold_ms(lambda a, w, _s: (a @ w.to(torch.bfloat16).T) * s16, x, copies, sc)
    print(f"[times] {name} {label}: kernel cold {k_ms!r} ms ({100 * bound_ms / k_ms:.1f} % of "
          f"the bound), warm {warm!r} ms ({100 * bound_ms / warm:.1f} %), cold back to back "
          f"{b2b!r} ms; plain cold {p_ms!r} ms; bound {bound_ms!r} ms by bytes "
          f"({info['bytes']} bytes); library call torch._weight_int8pack_mm cold {lib}; cold "
          f"over {len(copies)} weight copies, {len(copies) * wq.numel() / 2**20:.0f} MiB, each "
          f"call behind a kernel that writes x, whose own time is taken off (device time, "
          f"calls queued behind a spin kernel); card {card}", flush=True)
    print(f"[times] {name} {label}, also wq.to(bf16) + matmul + scale (three calls): cold "
          f"{pair_ms!r} ms; card {card}", flush=True)
    del copies
    return k_ms, p_ms, lib_ms


# ---------------------------------------------------------------------------
# Phase 5, continued: the split route at stt-1b rings, and the stt-2.6b path
# ---------------------------------------------------------------------------


def _lm_counters():
    from dsm_tpu_torch.ops import qmm as QM

    return {**_duplex_counters(), "qmm": QM.qmm}


def _with_fused(lm_cfg, fused_attn):
    import dataclasses

    return dataclasses.replace(
        lm_cfg, transformer=dataclasses.replace(lm_cfg.transformer, fused_attn=fused_attn))


def _lm_step_counted(lm_cfg, params, state, text, audio, mask):
    """One LM step from a clone of ``state`` -> (outputs, rings of every
    layer, launches of each kernel in that step)."""
    import torch

    from dsm_tpu_torch.models import lm as LM

    counters = _lm_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    with torch.inference_mode():
        logits, hidden, st = LM.step(lm_cfg, params, _clone(state), text, audio, mask)
    torch.cuda.synchronize()
    launched = {name: fn.launches - before[name] for name, fn in counters.items()}
    rings = [{key: layer[key] for key in ("k", "v", "ks", "vs")} for layer in st["t"]["layers"]]
    return {"hidden": hidden, "text_logits": logits}, rings, launched


def _compare_routes(tag, what, a, b, w, rtol=PATH_RTOL, layer0=True):
    """Two routes of one LM step from one state: outputs within ``rtol``
    (relative L2, by default PATH_RTOL, the bar of the other path checks:
    after several layers a rounding step of one attention output moves
    single elements by more);
    layer 0, whose input is the same in both, wrote the same four rings bit
    for bit; in every layer every ring row but ``w`` is untouched and equal.
    Deeper layers' row ``w`` is quantised from inputs that differ by the two
    attention kernels' summation orders and then rounded to int8 again (and
    to int8 activations before, under W8A8): its dequantised K and V are held
    to ROW_RTOL (relative L2); the layers where it is equal, the worst
    relative L2 and the worst int8 difference are reported."""
    import torch

    out_a, rings_a, _ = a
    out_b, rings_b, _ = b
    for key in out_a:
        check(bool(torch.isfinite(out_a[key]).all()), f"{tag}: {key} not finite")
        check(_rel(out_a[key], out_b[key]) <= rtol,
              f"{tag}: {key} of {what} {_rel(out_a[key], out_b[key])!r} from the other route")
    for key in ("k", "v", "ks", "vs") if layer0 else ():
        check(torch.equal(rings_a[0][key], rings_b[0][key]),
              f"{tag}: layer 0 ring {key} of {what} differs")
    same = 0
    worst = 0
    worst_rel = 0.0
    for ra, rb in zip(rings_a, rings_b):
        keep = torch.ones(ra["k"].shape[2], dtype=torch.bool, device=ra["k"].device)
        keep[w] = False
        for key in ("k", "v", "ks", "vs"):
            check(torch.equal(ra[key][:, :, keep], rb[key][:, :, keep]),
                  f"{tag}: {what} touched a ring row other than w")
        same += all(torch.equal(ra[key][:, :, w], rb[key][:, :, w]) for key in ra)
        for kv, sc in (("k", "ks"), ("v", "vs")):
            row_a = ra[kv][:, :, w].float() * ra[sc][:, :, w, None]
            row_b = rb[kv][:, :, w].float() * rb[sc][:, :, w, None]
            worst_rel = max(worst_rel, _rel(row_a, row_b))
            worst = max(worst, int((ra[kv][:, :, w].int() - rb[kv][:, :, w].int()).abs().max()))
    check(worst_rel <= ROW_RTOL,
          f"{tag}: row w of {what} is {worst_rel!r} from the other route's")
    err = {key: _rel(out_a[key], out_b[key]) for key in out_a}
    return same, f"{worst} int8 steps, {worst_rel!r} relative L2 dequantised", err


def phase_stt1b_split(dev):
    """Kernel 5's route on a path: the stt-1b LM (full width, 4 of its 16
    layers, B=64, int8 KV, W8A8) steps 24 frames, then one more from that
    state with the fused setting off (quantize_commit + decode_attend over the
    (64,16,768,128) rings) and one by the shape rule (quantize_scale_commit +
    decode_attend_commit)."""
    import dataclasses

    import torch

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.ops import transformer as T

    depth = 4
    preset = LM.stt_1b_en_fr()
    lm_cfg = dataclasses.replace(
        preset, transformer=dataclasses.replace(preset.transformer, num_layers=depth))
    gen = torch.Generator(device=dev).manual_seed(21)
    params = T.quantize_weights(LM.init(lm_cfg, gen, torch.bfloat16))
    b = 64
    state = LM.init_state(lm_cfg, b, torch.bfloat16, kv_quant=True, device=dev)
    ring = state["t"]["layers"][0]["k"]
    check(tuple(ring.shape) == (64, 16, 768, 128) and ring.dtype == torch.int8,
          "not the stt-1b int8 ring")
    mask = torch.ones(b, dtype=torch.bool, device=dev)

    def tokens():
        return (torch.randint(4, 200, (b,), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(0, 2048, (b, lm_cfg.audio_codebooks), generator=gen, device=dev,
                              dtype=torch.int32))

    with torch.inference_mode():
        for _ in range(24):
            state = LM.step(lm_cfg, params, state, *tokens(), mask)[2]
    text, audio = tokens()
    w = int(state["t"]["pos"]) % ring.shape[2]
    fused = _lm_step_counted(lm_cfg, params, state, text, audio, mask)
    split = _lm_step_counted(_with_fused(lm_cfg, False), params, state, text, audio, mask)
    want_split = {"rope_qk": depth, "quantize_commit": depth, "decode_attend": depth,
                  "rope_commit": 0, "qmm": 0, "quantize_scale_commit": 0,
                  "decode_attend_commit": 0, **_NONE}
    want_fused = {**want_split, "quantize_commit": 0, "decode_attend": 0,
                  "quantize_scale_commit": depth, "decode_attend_commit": depth}
    check(split[2] == want_split, f"stt1b-split: launches {split[2]}, want {want_split}")
    check(fused[2] == want_fused, f"stt1b-split: fused launches {fused[2]}")
    same, worst, err = _compare_routes("stt1b-split", "the split route", split, fused, w)
    print(f"[stt1b-split] stt-1b LM step, {depth} layers (a cut: 16 in the model), B=64, rings "
          f"{tuple(ring.shape)} holding {int(state['t']['pos'])} rows: fused setting off launches "
          f"{ {k: v for k, v in split[2].items() if v} }, the shape rule "
          f"{ {k: v for k, v in fused[2].items() if v} }; outputs relative L2 {err} (bar "
          f"{PATH_RTOL}); layer 0's four rings bit for bit, every row but w={w} of every layer "
          f"equal, row w equal in {same} of {depth} layers (worst {worst}, bar {ROW_RTOL})",
          flush=True)
    return split[2]


def phase_stt26(dev):
    """The stt-2.6b engine from its TOML as shipped, serving 12 sessions."""
    import torch

    from dsm_tpu_torch.ops import transformer as T
    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import config as CFG

    path = os.path.join(ROOT, "configs", "config-stt-en.toml")
    mod = CFG.Config.load(path).modules["asr"]
    print(f"[stt26] {os.path.relpath(path, ROOT)}: every key as in the file (w8a8 = "
          f"{mod.raw['w8a8']}, batch_size = {mod.batch_size}, asr_delay_in_tokens = "
          f"{mod.asr_delay_in_tokens})", flush=True)
    t0 = time.perf_counter()
    engine = builder.build_batched_asr(mod, dev, cuda_graph=False)  # [graph]: the captured one
    lm = engine.cfg.lm
    tcfg = lm.transformer
    check((tcfg.d_model, tcfg.num_layers, tcfg.num_heads, tcfg.hd, tcfg.context,
           lm.audio_codebooks, lm.text_out_vocab_size, lm.extra_heads, engine.batch_size,
           engine.cfg.asr_delay_in_tokens) == (2048, 48, 32, 64, 375, 32, 4000, None, 64, 32),
          "not the stt-2.6b B=64 config")
    check(engine.cfg.kv_quant and engine.cfg.mimi_dtype == "bfloat16", "not the serving profile")
    ring = engine.state["lm"]["t"]["layers"][0]
    check(tuple(ring["k"].shape) == (64, 32, 384, 64) and ring["k"].dtype == torch.int8
          and tuple(ring["ks"].shape) == (64, 32, 384), "not the int8 ring of stt-2.6b")
    layer = engine.params["lm"]["transformer"][0]
    leaves = [layer["in_proj_w"], layer["out_proj_w"], layer["mlp"]["linear_in"],
              layer["mlp"]["linear_out"], engine.params["lm"]["text_linear"]]
    for leaf in leaves:
        check(isinstance(leaf, dict) and leaf["q"].dtype == torch.int8
              and leaf.get("w8a8", True) is False and not T.w8a8_at(leaf, "in_proj"),
              "an LM weight is not int8 with the weight-only profile")
    check([tuple(leaf["q"].shape) for leaf in leaves] == [(o, i) for _, o, i in QMM_SHAPES[:5]],
          "the LM's matmuls are not the shapes the qmm cases hold")
    check(PER_STEP_STT26["qmm"] == 4 * tcfg.num_layers + 1
          and PER_STEP_STT26["decode_attend"] == tcfg.num_layers,
          "PER_STEP_STT26 does not follow the config")
    torch.cuda.synchronize()
    print(f"[stt26] engine built in {time.perf_counter() - t0:.3f} s (stt-2.6b d=2048 L=48 "
          f"h=32x64 ctx 375 K=32 B=64, int8 rings {tuple(ring['k'].shape)}, weight-only int8 "
          f"weights, no VAD heads, bf16 codec, seeded random weights); memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak while building "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    t0 = time.perf_counter()
    engine.warmup()
    print(f"[stt26] warmup {time.perf_counter() - t0:.3f} s", flush=True)

    # No W8A8 anywhere on this path: the library's int8 GEMM must not run.
    int_mm, calls = torch._int_mm, []

    def counted_int_mm(*a, **kw):
        calls.append(1)
        return int_mm(*a, **kw)

    torch._int_mm = counted_int_mm
    try:
        launches = _serve_asr(engine, _lm_counters(), PER_STEP_STT26, "stt26")
    finally:
        torch._int_mm = int_mm
    check(not calls, f"torch._int_mm ran {len(calls)} times on the weight-only path")
    print("[stt26] torch._int_mm calls while serving: 0", flush=True)
    return engine, launches


def phase_stt26_path(engine, dev):
    """One LM step of the stt-2.6b engine from its state after the timed
    steps (every slot active): through the kernels against the same step
    through their plain versions (relative L2, PATH_RTOL), and with the
    fused setting on (48 quantize_scale_commit + 48 decode_attend_commit at h=32,
    Dh=64) against the split route."""
    import torch

    from dsm_tpu_torch.models import lm as LM

    lm_cfg, params, state = engine.cfg.lm, engine.params["lm"], engine.state["lm"]
    n = engine.batch_size
    g = torch.Generator(device=dev).manual_seed(19)
    text = torch.randint(4, 200, (n,), generator=g, device=dev, dtype=torch.int32)
    audio = torch.randint(0, 2048, (n, lm_cfg.audio_codebooks), generator=g, device=dev,
                          dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    pos = int(state["t"]["pos"])  # for the lines below: read outside the step
    w = pos % state["t"]["layers"][0]["k"].shape[2]
    seen = int(state["t"]["valid"].sum(dim=1).min())

    split = _lm_step_counted(lm_cfg, params, state, text, audio, mask)
    layers = lm_cfg.transformer.num_layers
    want = {"rope_qk": layers, "quantize_commit": layers, "decode_attend": layers,
            "rope_commit": 0, "qmm": 4 * layers + 1, "quantize_scale_commit": 0,
            "decode_attend_commit": 0, **_NONE}
    check(split[2] == want, f"stt26-path: launches {split[2]}, want {want}")
    with plain_seams(), torch.inference_mode():
        plain = LM.step(lm_cfg, params, _clone(state), text, audio, mask)
        forgot = _clone(state)
        forgot["t"]["valid"].zero_()
        empty = LM.step(lm_cfg, params, forgot, text, audio, mask)
    rel = {"hidden": _rel(split[0]["hidden"], plain[1]),
           "text_logits": _rel(split[0]["text_logits"], plain[0])}
    history = _rel(empty[1], plain[1])
    del plain, empty, forgot
    for key, r in rel.items():
        check(r <= PATH_RTOL, f"stt26-path: {key} through the kernels {r!r} from the plain path")
    check(history > PATH_RTOL,
          f"stt26-path: the ring's history moves the hidden state only {history!r}")
    print(f"[stt26-path] {n} active rows at tick {pos} (every slot with at least {seen} valid "
          f"ring rows), LM step through rope_qk + quantize_commit + decode_attend + qmm "
          f"({split[2]}) "
          f"against their plain versions from one state: relative L2 hidden "
          f"{rel['hidden']!r}, text logits {rel['text_logits']!r} (bar {PATH_RTOL}); with the "
          f"ring's history masked the hidden state moves {history!r}", flush=True)

    fused = _lm_step_counted(_with_fused(lm_cfg, True), params, state, text, audio, mask)
    want_fused = {**want, "quantize_commit": 0, "decode_attend": 0, "quantize_scale_commit": layers,
                  "decode_attend_commit": layers}
    check(fused[2] == want_fused, f"stt26-path: fused launches {fused[2]}, want {want_fused}")
    same, worst, err = _compare_routes("stt26-path", "the fused route", fused, split, w)
    print(f"[stt26-path] the same step with the fused setting on: launches "
          f"{ {k: v for k, v in fused[2].items() if v} }; outputs relative L2 from the split "
          f"route {err} (bar {PATH_RTOL}); layer 0's four rings bit for bit, every row but w={w} "
          f"of every layer equal, row w equal in {same} of {layers} layers (worst {worst}, "
          f"bar {ROW_RTOL}: deeper layers quantise inputs that differ by the attention "
          f"kernels' summation order)", flush=True)
    return fused[2]


# ---------------------------------------------------------------------------
# The captured step: BatchedAsrEngine replaying its step as one CUDA graph
# ---------------------------------------------------------------------------

# Steps the graph step is held to the eager step over, and whether they pass a
# wrap of the LM's ring: the stt-1b LM's 768-row ring and the codec's 256-row
# ring (2 rows a step), the stt-2.6b LM's 384-row ring; a short check of the
# packed-int4 rings, past a wrap of the codec's ring only.
# Steps of each replay check and whether its LM ring wraps: that check starts its
# rings full, half its steps before the third wrap.
GRAPH_STEPS = {"stt1b": (200, True), "stt26": (160, True), "stt1b-kv4": (160, False)}
GRAPH_CHECK_EVERY = 100  # steps between whole-state comparisons (and at the end)


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (a NaN equals the same NaN)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _tree_diff(a, b, path=""):
    """The paths of two state trees' tensors that differ in any bit."""
    if isinstance(a, dict):
        return [p for k in a for p in _tree_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _tree_diff(x, y, f"{path}/{i}")]
    return [] if _bits_equal(a, b) else [path]


def _graph_traffic(b, frame, steps, seed):
    """``steps`` engine inputs from a seed: slots open and close along the
    way (an open slot's stream ends with probability 1/40 a step, a closed
    slot opens again with 1/10 and is reset then), and an open slot has a
    frame 9 steps in 10, so masks are partial."""
    import numpy as np

    rng = np.random.default_rng(seed)
    active = rng.uniform(size=b) < 0.8
    for i in range(steps):
        opening = ~active & (rng.uniform(size=b) < 0.1)
        closing = active & (rng.uniform(size=b) < 0.025)
        reset = opening | (active & (i == 0))
        active = (active | opening) & ~closing
        mask = active & (rng.uniform(size=b) < 0.9)
        pcm = (rng.standard_normal((b, 1, frame)) * 0.1).astype(np.float32)
        yield pcm, mask, reset


def _graph_times(engine, tag, what, card, rope_per_step):
    """Host ms a step (median, min, max over 50, every slot active), the
    device's busy share and device launches a step from a profile of 2 steps,
    and the peak memory (the caching allocator's reserved bytes, a captured
    graph's private pool included) since the caller reset it."""
    import numpy as np
    import torch

    b = engine.batch_size
    pcm = (np.random.default_rng(7).standard_normal((b, 1, engine.frame_size)) * 0.1
           ).astype(np.float32)
    on, off = np.ones(b, bool), np.zeros(b, bool)
    times = []
    with torch.inference_mode():
        engine._invoke_step(pcm, on, on)  # every slot fresh
        for i in range(55):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine._invoke_step(pcm, on, off)
            torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(out["text_token"].float()).all()), f"{tag}: bad tokens")
        rows, wall_us = _profile(lambda: engine._invoke_step(pcm, on, off), 2,
                                 rope_launches=2 * rope_per_step)
    kernel_ms = _print_profile(f"{tag}-profile", what, rows, wall_us, 2, "step", card, 6)
    launches = sum(c for _, _, c in rows) / 2
    peak = torch.cuda.max_memory_reserved() / 1e9
    peak_alloc = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(times)
    print(f"[{tag}] {what}engine step, {b} slots active: median {step_ms!r} ms, min "
          f"{min(times)!r}, max {max(times)!r} over 50 after 5 warm-up; device busy "
          f"{kernel_ms / (wall_us / 2 / 1e3)!r}; {launches:.0f} device launches a step; peak "
          f"memory {peak:.2f} GB reserved ({peak_alloc:.2f} GB allocated); card {card}",
          flush=True)
    return {"step_ms": step_ms, "min_ms": min(times), "max_ms": max(times),
            "busy": kernel_ms / (wall_us / 2 / 1e3), "launches": launches,
            "kernel_ms": kernel_ms, "peak_gb": peak}


def _graph_serve(cfg, params, batch, per_step, tag):
    """The 12-session workload of ``[serve]`` (8 sessions, then 4 more in
    reused slots, idle connections in the other slots) through an eager and a
    captured engine on the same pcm, fill gate off so that both step the same
    frames: each session's step events, words (tokens and times) and markers
    equal.  The kernels' counts start at 0 before the captured engine is
    built and are read after it served: its warm-up steps and its capture
    count, its replays do not."""
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine

    counters = _lm_counters()
    logs = {}
    for graph in (False, True):
        if graph:
            for fn in counters.values():
                fn.launches = 0
        engine = BatchedAsrEngine(cfg, params, batch_size=batch, device="cuda",
                                  fill_gate_frac=0.0, cuda_graph=graph)
        engine.warmup()
        sessions = {}
        for sid in range(8):  # seeded, so that sampling at temperature > 0 agrees too
            _open(engine, sid, 3.0 + sid / 8.0, sessions, seed=sid)
        idle = [engine.open_channel(lambda ev: None, seed=0)
                for _ in range(engine.batch_size - engine.used_slots())]
        _drive(engine, sessions)
        for sid in range(4):
            engine.close_channel(sessions[sid]["ch"])
        for sid in range(8, 12):
            _open(engine, sid, 1.0, sessions, seed=sid)
        _drive(engine, {sid: sessions[sid] for sid in range(4, 12)})
        _verify(sessions, range(12), cfg.lm.extra_heads[0] if cfg.lm.extra_heads else 0)
        for ch in [s["ch"] for s in sessions.values()] + idle:
            engine.close_channel(ch)
        logs[graph] = ({sid: [(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                                             getattr(w, "start_time", None),
                                             getattr(w, "stop_time", None)) for w in e.words],
                               list(e.markers)) for e in s["events"]]
                        for sid, s in sessions.items()}, engine.step_count)
        launches = {name: fn.launches for name, fn in counters.items()}
        del engine
    check(logs[True] == logs[False],
          f"{tag}: the captured engine's events differ from the eager engine's")
    warm = 2  # BatchedAsrEngine.warmup's steps, then the capture
    want = {name: n * (warm + 1) for name, n in per_step.items()}
    want = {**dict.fromkeys(counters, 0), **want}
    check(launches == want, f"{tag}: launches {launches}, want {want} (warm-up + capture)")
    words = sum(len(e[1]) for evs in logs[True][0].values() for e in evs)
    print(f"[{tag}] captured engine serves the 12-session workload of [serve] (fill gate off "
          f"in both): {logs[True][1]} engine steps, {words} word events, 12 markers; step "
          f"events, words and markers equal to the eager engine's; kernel launches counted "
          f"over its warm-up and capture {launches} = {warm + 1} x per step, none on replay",
          flush=True)
    return launches


def phase_graph(cfg, params, batch, card, tag, per_step, serve=False, timed=True):
    """The ASR step as one captured CUDA graph (``BatchedAsrEngine`` with
    ``cuda_graph``) against the eager step.  Timed: an eager engine's step,
    then a captured engine's (host ms, device busy share and launches a step
    from the profile, peak memory with the graph's pool).  Then the eager
    ``ASR.step`` runs beside the captured engine from a clone of its state
    over ``GRAPH_STEPS`` steps of traffic with slots opening, closing and
    reset and partial masks: every step's outputs (text token, step_idx,
    VAD probabilities, codes) equal bit for bit, and every ``GRAPH_CHECK_EVERY``
    steps and at the end the whole state (rings, scale rings, ``valid``,
    ``pos``, conv and codec carries, counters).  With ``serve`` the captured
    engine serves the 12-session workload beside an eager engine."""
    import numpy as np
    import torch

    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.sessions import asr as ASR

    numbers = {}
    rope = per_step["rope_qk"] + per_step["rope_commit"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = BatchedAsrEngine(cfg, params, batch_size=batch, device="cuda", cuda_graph=True)
    engine.warmup()  # two steps on the side stream, then the capture
    capture_s = time.perf_counter() - t0
    check(engine._graph is not None, f"{tag}: no graph captured")
    if timed:
        numbers["graph"] = _graph_times(engine, tag, "captured: ", card, rope)
    steps, lm_wraps = GRAPH_STEPS[tag.split("graph-")[-1]]
    lm_ring = engine.state["lm"]["t"]["valid"].shape[1]
    if lm_wraps:
        _fill_rings(engine.state["lm"]["t"], torch.Generator(device="cuda").manual_seed(33),
                    3 * lm_ring - steps // 2)
    ref = _clone(engine.state)
    b, frame = engine.batch_size, engine.frame_size
    dev = torch.device("cuda")
    seeds = torch.as_tensor(engine._seeds, device=dev)
    resets = closed = partial = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i, (pcm, mask, reset) in enumerate(_graph_traffic(b, frame, steps, seed=41)):
            resets += int(reset.sum())
            partial += int(0 < mask.sum() < b)
            closed += int((~mask).sum())
            got = engine._invoke_step(pcm, mask, reset)
            want, ref = ASR.step(cfg, params, ref, torch.as_tensor(pcm, device=dev),
                                 torch.as_tensor(mask, device=dev),
                                 torch.as_tensor(reset, device=dev), seeds=seeds)
            for key in ("text_token", "step_idx", "prs", "codes"):
                check(_bits_equal(got[key], want[key]),
                      f"{tag}: step {i}: {key} of the replay differs from the eager step's")
            if (i + 1) % GRAPH_CHECK_EVERY == 0 or i + 1 == steps:
                diff = _tree_diff(engine.state, ref)
                check(not diff, f"{tag}: step {i}: the state differs at {diff[:5]}")
    lm_pos, codec_pos = int(ref["lm"]["t"]["pos"]), int(ref["mimi_enc"]["enc_t"]["pos"])
    codec_ring = engine.state["mimi_enc"]["enc_t"]["layers"][0]["k"].shape[2]
    check(2 * steps > codec_ring and (lm_pos > 3 * lm_ring or not lm_wraps),
          f"{tag}: the rings did not wrap")
    print(f"[{tag}] captured in {capture_s:.2f} s with the warm-up; {steps} steps of "
          f"{cfg.lm.transformer.num_layers} layers from one state, replay against the eager "
          f"ASR.step: text tokens, step_idx, VAD probabilities and codes bit for bit at every "
          f"step, the whole state (rings, scale rings, valid, pos, conv and codec carries) "
          f"every {GRAPH_CHECK_EVERY} steps and at the end; LM rings "
          f"{'full of quantised rows from ' + str(3 * lm_ring - steps // 2) if lm_wraps else 'fresh'}"
          f"; {resets} slot resets, {closed} "
          f"slot-steps without a frame, {partial} partial masks; LM ring of {lm_ring} rows at "
          f"tick {lm_pos}, codec ring of {codec_ring} at tick {codec_pos}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del engine, ref
    torch.cuda.empty_cache()
    if serve:
        numbers["launches"] = _graph_serve(cfg, params, batch, per_step, f"{tag}-serve")
    return numbers


# ---------------------------------------------------------------------------
# Phase 8 (STT): packed-int4 rings on the stt-1b engine and the stt-2.6b LM step
# ---------------------------------------------------------------------------


def phase_stt1b_kv4(dev, card, int8_numbers):
    """The stt-1b engine of configs/config-stt.toml with ``AsrConfig(kv_bits=4)``
    handed to ``BatchedAsrEngine`` (the ASR builder reads no ``kv_bits`` key):
    12 sessions, exact launches, then the step's time and peak memory beside
    the int8 engine's of this run."""
    import dataclasses

    import torch

    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import config as CFG
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine

    mod = CFG.Config.load(os.path.join(ROOT, "configs", "config-stt.toml")).modules["asr"]
    built = builder.build_batched_asr(mod, dev, cuda_graph=False)
    cfg = dataclasses.replace(built.cfg, kv_bits=4)
    params, batch, tokenizer = built.params, built.batch_size, built.tokenizer
    del built  # its int8 rings go before the int4 engine allocates its own
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = BatchedAsrEngine(cfg, params, batch_size=batch, device=dev,
                              fill_gate_frac=float(mod.raw.get("fill_gate_frac", 0.2)),
                              cuda_graph=False)
    engine.tokenizer = tokenizer
    tcfg = engine.cfg.lm.transformer
    ring = engine.state["lm"]["t"]["layers"][0]
    check((tcfg.d_model, tcfg.num_layers, tcfg.num_heads, engine.batch_size)
          == (2048, 16, 16, 64), "not the stt-1b B=64 config")
    check(ring["k"].dtype == torch.uint8 and tuple(ring["k"].shape) == (64, 16, 768, 64)
          and tuple(ring["ks"].shape) == (64, 16, 768), "not the packed-int4 ring of stt-1b")
    check(PER_STEP_STT1B_KV4["decode_attend"] == tcfg.num_layers,
          "PER_STEP_STT1B_KV4 does not follow the config")
    engine.warmup()
    print(f"[stt1b-kv4] engine from configs/config-stt.toml with AsrConfig(kv_bits=4): rings "
          f"uint8 {tuple(ring['k'].shape)}, scales f32 {tuple(ring['ks'].shape)}, B=64, "
          f"int8 weights + W8A8, bf16 codec, seeded random weights", flush=True)
    launches = _serve_asr(engine, _duplex_counters(), PER_STEP_STT1B_KV4, "stt1b-kv4")
    step_ms, peak_gb, kernel_ms = phase_times(engine, dev, card, tag="stt1b-kv4-")
    print(f"[stt1b-kv4] int4 rings beside int8 rings (this run, the same card): engine step "
          f"median {step_ms!r} ms against {int8_numbers[0]!r}; kernels {kernel_ms!r} ms a step "
          f"against {int8_numbers[2]!r}; peak memory {peak_gb:.2f} GB against "
          f"{int8_numbers[1]:.2f} GB; card {card}", flush=True)
    del engine
    torch.cuda.empty_cache()
    phase_graph(cfg, params, batch, card, "graph-stt1b-kv4", PER_STEP_STT1B_KV4, timed=False)
    return launches


def phase_stt26_kv4(engine, dev, card):
    """The stt-2.6b LM (48 layers, weight-only int8 weights, the engine's own)
    over packed-int4 rings uint8 (64,32,384,32), the int8 rings built the same
    way beside them.  One step through the kernels against the same step
    through their plain versions (relative L2 of the hidden state and the
    text logits), each side's launches counted, from three states: after 40
    steps of random tokens; over full, wrapped rings of real quantised rows
    (:func:`_fill_rings`), where a bit-identical pair fails and the LM step is
    timed; and, held to no bar since no engine reaches it, the 40 rows with
    every never-written row marked valid at a scale of 1e-3 (a packed ring
    reads its zero bytes as -8).  From each state the step also runs with
    the ring kernels alone (quantize_commit + decode_attend, qmm plain) and
    with qmm alone through its kernel: which kernel's summation order moves
    the outputs, and how far (over full rings qmm alone passes PATH_RTOL, so
    steps that launch it are held to FULL_RING_RTOL there); and every
    decode_attend launch of the all-kernels step is held to its plain version
    on the same operands (SEAM_RTOL)."""
    import torch

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import qmm as QM
    from dsm_tpu_torch.ops import ring_kernels as RK

    lm_cfg, params, n = engine.cfg.lm, engine.params["lm"], engine.batch_size
    layers = lm_cfg.transformer.num_layers
    g = torch.Generator(device=dev).manual_seed(23)
    mask = torch.ones(n, dtype=torch.bool, device=dev)

    def tokens():
        return (torch.randint(4, 200, (n,), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, 2048, (n, lm_cfg.audio_codebooks), generator=g, device=dev,
                              dtype=torch.int32))

    history = [tokens() for _ in range(40)]
    text, audio = tokens()
    ring_launches = {"rope_qk": layers, "quantize_commit": layers, "decode_attend": layers}
    want_launches = {**ring_launches, "rope_commit": 0, "qmm": 4 * layers + 1,
                     "quantize_scale_commit": 0, "decode_attend_commit": 0, **_NONE}
    counters = _lm_counters()
    ring_seams, qmm_seam = (RK.quantize_commit, DA._attend_launch, RK.rope_qk), QM._launch

    def step(state, ring_kernels, qmm_kernel, seam=None):
        """One step from a clone of ``state`` -> (text logits, hidden state),
        the ring kernels and qmm each through the kernel or the plain version;
        ``seam`` collects :func:`attend_seam_errors`."""
        before = {name: fn.launches for name, fn in counters.items()}
        with plain_seams(), torch.inference_mode(), contextlib.ExitStack() as stack:
            if ring_kernels:
                RK.quantize_commit, RK.rope_qk = ring_seams[0], ring_seams[2]
                stack.enter_context(attend_seam_errors(seam, ring_seams[1]))
            if qmm_kernel:
                QM._launch = qmm_seam
            out = LM.step(lm_cfg, params, _clone(state), text, audio, mask)[:2]
        torch.cuda.synchronize()
        launched = {name: fn.launches - before[name] for name, fn in counters.items()}
        want = {**dict.fromkeys(counters, 0), **(ring_launches if ring_kernels else {}),
                "qmm": want_launches["qmm"] if qmm_kernel else 0}
        check(launched == want, f"stt26-kv4: launches {launched}, want {want}")
        return out

    def compare(state):
        """Relative L2 (hidden state, text logits) from the plain step of the
        step through all kernels, the ring kernels alone and qmm alone; under
        "seam" the worst decode_attend launch of the first from its plain
        version on the same operands; and how far the ring's history moves
        the plain hidden state."""
        plain = step(state, False, False)
        rel, seam = {}, []
        for which, (ring_kernels, qmm_kernel) in (("all", (True, True)), ("rings", (True, False)),
                                                  ("qmm", (False, True))):
            got = step(state, ring_kernels, qmm_kernel, seam if which == "all" else [])
            check(all(bool(torch.isfinite(x).all()) for x in got), "stt26-kv4: not finite")
            rel[which] = (_rel(got[1], plain[1]), _rel(got[0], plain[0]))
        check(len(seam) == layers, f"stt26-kv4: {len(seam)} decode_attend launches compared")
        rel["seam"] = max(seam, default=float("inf"))
        forgot = _clone(state)
        forgot["t"]["valid"].zero_()
        return rel, _rel(step(forgot, False, False)[1], plain[1])

    # The kernels of decode_attend (no ring commit: both legs run quantize_commit
    # + decode_attend, as want_launches holds), by name in the profile.
    attend_kernels = {4: ("decode_attend_q4_kernel", "decode_attend_combine_kernel"),
                      8: ("decode_attend_q8_kernel", "decode_attend_combine_kernel")}

    def profile(state, bits):
        """(all kernels, decode_attend's kernels) ms a step from ``state``,
        its row w committed again at each step."""
        with torch.inference_mode():

            def lm_step():
                return LM.step(lm_cfg, params, state, text, audio, mask)

            total, by_name = _kernel_ms(lm_step)
        return total, sum(ms for name, ms in by_name.items()
                          if any(k in name for k in attend_kernels[bits]))

    rel, moved, medians, kernels = {}, {}, {}, {}
    for bits in (4, 8):
        state = LM.init_state(lm_cfg, n, torch.bfloat16, kv_quant=True, device=dev,
                              kv_bits=bits)
        ring = state["t"]["layers"][0]
        if bits == 4:
            check(ring["k"].dtype == torch.uint8
                  and tuple(ring["k"].shape) == (64, 32, 384, 32)
                  and tuple(ring["ks"].shape) == (64, 32, 384),
                  "not the packed-int4 ring of stt-2.6b")
        with torch.inference_mode():
            for tok in history:
                state = LM.step(lm_cfg, params, state, *tok, mask)[2]
        got = _lm_step_counted(lm_cfg, params, state, text, audio, mask)  # no seam touched
        check(got[2] == want_launches, f"stt26-kv4: kv_bits {bits} launches {got[2]}")
        del got
        rel[bits, "40 rows"], moved[bits, "40 rows"] = compare(state)
        kernels[bits, "40 rows"] = profile(_clone(state), bits)

        unwritten = _clone(state)
        with torch.inference_mode():
            unwritten["t"]["pos"] = torch.full_like(unwritten["t"]["pos"], 3000)
            unwritten["t"]["valid"].fill_(True)
            for layer in unwritten["t"]["layers"]:
                layer["ks"].clamp_(min=1e-3)
                layer["vs"].clamp_(min=1e-3)
        rel[bits, "unwritten"], moved[bits, "unwritten"] = compare(unwritten)
        del unwritten

        _fill_rings(state["t"], torch.Generator(device=dev).manual_seed(31), 3000)
        rel[bits, "full"], moved[bits, "full"] = compare(state)
        with torch.inference_mode():

            def lm_step(state=state):
                return LM.step(lm_cfg, params, state, text, audio, mask)  # row w again

            medians[bits] = _median_ms(lm_step)
        kernels[bits, "full"] = profile(state, bits)
        del state
        torch.cuda.empty_cache()
    states = {"40 rows": "holding 40 rows",
              "full": "full and wrapped (tick 3000, 384 real quantised rows)",
              "unwritten": "holding 40 rows, the 344 never-written rows marked valid at scale "
                           "1e-3 (tick 3000; no engine reaches this state: no bar)"}
    for where, what in states.items():
        for bits in (4, 8):
            r = rel[bits, where]
            print(f"[stt26-kv4] stt-2.6b LM step, {layers} layers, B={n}, kv_bits = {bits}, rings "
                  f"{what}: relative L2 (hidden state, text logits) from the plain step, both "
                  f"sides' launches counted: all kernels {r['all']!r}, quantize_commit + "
                  f"decode_attend alone {r['rings']!r}, qmm alone {r['qmm']!r} (bar "
                  f"{PATH_RTOL}; over full rings {FULL_RING_RTOL} where qmm is a kernel, "
                  f"{Q4_ALONE_FULL_RTOL['stt26-kv4']} decode_attend alone over int4); each "
                  f"layer's decode_attend from its plain version on the same operands at most "
                  f"{r['seam']!r} (bar {SEAM_RTOL}); with the ring's history masked the hidden "
                  f"state moves {moved[bits, where]!r}", flush=True)
    for bits in (4, 8):
        med, lo, hi = medians[bits]
        print(f"[stt26-kv4] LM step alone over the full rings, "
              f"kv_bits = {bits}: median {med!r} ms, min {lo!r}, max {hi!r} over 10 after 3 "
              f"warm-up (host clock with synchronize); card {card}", flush=True)
        for where in ("40 rows", "full"):
            total, attend = kernels[bits, where]
            print(f"[stt26-kv4] LM step, kv_bits = {bits}, rings {states[where]}: kernels "
                  f"{total!r} ms a step, of them decode_attend's {layers} calls "
                  f"({' + '.join(attend_kernels[bits])}) {attend!r} ms (profiler, 2 steps); "
                  f"card {card}", flush=True)
    for bits in (4, 8):
        for where in ("40 rows", "full"):
            for which in ("all", "rings", "qmm"):
                r = rel[bits, where][which]
                bar = FULL_RING_RTOL if where == "full" and which != "rings" else PATH_RTOL
                if (bits, where, which) == (4, "full", "rings"):
                    bar = Q4_ALONE_FULL_RTOL["stt26-kv4"]
                check(max(r) <= bar, f"stt26-kv4: kv_bits {bits}, rings {where}, {which} "
                      f"kernels: {r!r} from the plain path (bar {bar})")
            check(rel[bits, where]["seam"] <= SEAM_RTOL, f"stt26-kv4: kv_bits {bits}, rings "
                  f"{where}: decode_attend {rel[bits, where]['seam']!r} from its plain version")
            check(moved[bits, where] > PATH_RTOL, f"stt26-kv4: kv_bits {bits}, {where}: the "
                  f"ring's history moves the hidden state only {moved[bits, where]!r}")
        check(min(rel[bits, "full"]["rings"]) > 0,
              f"stt26-kv4: kv_bits {bits}: ring kernels and plain versions bit-identical over "
              f"full rings")
    return want_launches


# ---------------------------------------------------------------------------
# Phase 6: the batched TTS path
# ---------------------------------------------------------------------------

TTS_TEXTS = ["hello there friend", "the quick brown fox", "one two three four",
             "good morning to you", "it is a fine day", "see you later now",
             "what a lovely voice", "streams of words here", "all done for today",
             "voices on the card", "short one", "last of the batch"]


# [tts] and [tts202501] serve the 16-session workload eagerly, and their
# [graph-*] phases hold the captured engine's served events to it, where the
# tag is listed here; elsewhere the eager engine counts TTS_EAGER_TICKS ticks
# with every slot open.  [tts202501]'s serve (92 eager ticks at 48 layers,
# 45-67 s) does not fit in the script's 900 s (ROADMAP queue 3, item 5).
TTS_EAGER_SERVED = ("tts",)
TTS_EAGER_TICKS = 4
# The texts of [tts202501] (tts_202501 at TTS202501_LAYERS layers): its eager
# ticks (0.5-0.6 s at 48 layers, host-bound) are most of its phases' time, so
# two words a session; tts-1.6b's [tts] and [graph-tts] take TTS_TEXTS.
TTS_SHORT_TEXTS = ["hello there", "quick fox", "one two", "good morning", "fine day", "see you"]


def _tts_open(engine, sid, voice, sessions, words=True, texts=TTS_TEXTS):
    events = []
    ca = engine.voice_kv(voice) if voice else None
    drv = engine.open_session(events.append, voice_ca=ca, seed=100 + sid,
                              text_temperature=0.6, audio_temperature=0.8)
    check(drv is not None, "no free TTS slot")
    text = texts[sid % len(texts)] if words else ""
    if words:
        enc, _ = engine.encode_words(text, inserted_bos=False)
        drv.feed_words(enc)
        drv.end_input()
    sessions[sid] = {"drv": drv, "events": events, "text": text}
    return drv


def _tts_drive(engine, sessions, limit_s=400.0):
    from dsm_tpu_torch.server.tts_batched import DoneEvent

    deadline = time.monotonic() + limit_s
    while not all(any(isinstance(e, DoneEvent) for e in s["events"])
                  for s in sessions.values()):
        check(time.monotonic() < deadline, "TTS sessions did not finish")
        engine.tick()


def _tts_verify(sessions, sids, frame):
    import numpy as np

    from dsm_tpu_torch.server.tts_batched import DoneEvent
    from dsm_tpu_torch.server.tts_module import AudioEvent, WordEvent

    n_frames = 0
    for sid in sids:
        s = sessions[sid]
        evs = s["events"]
        check(isinstance(evs[-1], DoneEvent), f"tts session {sid}: does not end in Done")
        words = [e.text for e in evs if isinstance(e, WordEvent)]
        check(words == s["text"].split(), f"tts session {sid}: words {words} "
              f"for {s['text']!r}")
        audio = [e.pcm for e in evs if isinstance(e, AudioEvent)]
        check(len(audio) > 0, f"tts session {sid}: no audio")
        for pcm in audio:
            check(pcm.shape == (frame,) and bool(np.isfinite(pcm).all()),
                  f"tts session {sid}: bad frame {pcm.shape}")
        n_frames += len(audio)
    return n_frames


def _profile(fn, n: int, attempts: int = 4, rope_launches=None, spans=None):
    """``n`` calls of ``fn`` under the profiler -> the kernels as ``(name,
    device us, launches)`` by falling device time, and the calls' wall time
    in us.  Device activity only: with the host's operator events as well
    (several for each launch) the profiler takes tens of seconds to hand over
    a tick's 20,000 launches.  A profile that holds fewer rope kernels than
    the wrappers counted in the calls (``rope_launches`` where the calls
    replay a captured graph, whose launches no wrapper counts) lost events (a
    TTS tick's profile once held none of its LM step's launches) and is taken
    again.  Where every attempt holds no device event at all (CUPTI lost them
    all: seen once, from a point of a run on), the calls are timed with CUDA
    events instead: one row, named so, of their elapsed device time, with no
    launch counted.  ``spans``: a list given the ``(start, end)`` us of every
    device event of the profile kept (the device's busy time where kernels
    overlap)."""
    import torch

    from dsm_tpu_torch.ops import ring_kernels as RK

    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(attempts):
        launched = RK.rope_commit.launches + RK.rope_qk.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = RK.rope_commit.launches + RK.rope_qk.launches - launched
        if rope_launches is not None:
            launched = rope_launches
        rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                       if e.device_type == cuda and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        seen = sum(c for key, _, c in rows if "rope_commit_kernel" in key)
        if spans is not None:
            spans[:] = [(e.time_range.start, e.time_range.end) for e in prof.events()
                        if e.device_type == cuda]
        if seen == launched:
            break
        print(f"[profile] attempt {attempt + 1}: the profiler holds {seen} of the {launched} "
              f"rope launches of the calls: events lost, "
              f"{'profiled again' if attempt + 1 < attempts else 'numbers below incomplete'}",
              flush=True)
    if not rows:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        rows = [("(the profiler lost every event: CUDA-event elapsed time of the calls, "
                 "not kernel time)", start.elapsed_time(end) * 1e3, 0)]
        print(f"[profile] the profiler held no device event in {attempts} attempts: the calls "
              f"timed with CUDA events instead, {rows[0][1] / n / 1e3!r} ms a call (elapsed, "
              f"idle gaps included; no launch counted)", flush=True)
    check(rows[0][1] > 0, "no device time measured")
    return rows, wall_us


# Name stems of the port's kernels (dsm_tpu_torch/csrc/, each in an anonymous
# namespace): a profile lists these wherever they rank.
PORT_KERNELS = ("ring_commit", "rope_commit", "scale_commit", "quantize_commit",
                "decode_attend", "ca_decode_attend", "qmm",
                "attn_tune")


PROFILES = {}  # (tag, what) -> (kernel ms, device launches) a step or tick


def _print_profile(tag, what, rows, wall_us, n, unit, card, top):
    """The profile's summary line, its ``top`` kernels and then the port's own
    kernels wherever they rank -> kernel ms a call."""
    total = sum(t for _, t, _ in rows)
    PROFILES.setdefault((tag, what), (total / n / 1e3, sum(c for _, _, c in rows) / n))
    print(f"[{tag}] {what}kernels {total / n / 1e3!r} ms/{unit} of {wall_us / n / 1e3!r} "
          f"ms/{unit} wall (profiled over {n}): device busy {total / wall_us!r}, "
          f"{sum(c for _, _, c in rows) / n:.0f} device launches/{unit}, {len(rows)} kernel "
          f"names; card {card}", flush=True)
    for i, (key, t, c) in enumerate(rows):
        if i < top or any(f"(anonymous namespace)::{k}" in key for k in PORT_KERNELS):
            print(f"[{tag}] {t / n / 1e3:9.4f} ms/{unit} {100 * t / total:5.1f}% "
                  f"{c / n:6.0f}/{unit}  {key[:90]}", flush=True)
    return total / n / 1e3


def _kernel_ms(fn, n: int = 2):
    """Device time of ``fn``'s kernels by name, ms per call, summed by the
    profiler over ``n`` calls after one unprofiled -> ``(total, {kernel
    name: ms})``."""
    fn()
    rows, _ = _profile(fn, n)
    by_name = {key: t / n / 1e3 for key, t, _ in rows}
    return sum(by_name.values()), by_name


def _median_ms(fn, n: int = 10, warmup: int = 3):
    import torch

    ts = []
    for i in range(n + warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def _tts_counters(per_tick):
    from dsm_tpu_torch.ops import decode_attn as DA

    counters = {**_duplex_counters(), "ca_decode_attend": DA.ca_decode_attend}
    return {name: counters[name] for name in per_tick}


def _tts_module(tag, preset=None):
    """configs/config-tts-tpu-serving.toml's TTS module with ``fuse_ticks``
    and ``pipeline_depth`` set to 1 (the single-tick path; ``[graph-tts-serving]``
    serves the file as shipped); ``preset`` puts that ``LM`` preset in place of
    the TOML's model."""
    import dataclasses

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.server import config as CFG

    path = os.path.join(ROOT, "configs", "config-tts-tpu-serving.toml")
    mod = CFG.Config.load(path).modules["tts"]
    model = (f"its lm replaced by the preset LM.{preset}() at {TTS202501_LAYERS} of its "
             f"48 layers" if preset else "its own model")
    print(f"[{tag}] {os.path.relpath(path, ROOT)} with {model}: fuse_ticks "
          f"{mod.raw['fuse_ticks']} -> 1, "
          f"pipeline_depth {mod.raw['pipeline_depth']} -> 1 (the single-tick path; "
          f"[graph-tts-serving] serves the file as shipped); every other key as in the file",
          flush=True)
    mod.raw["fuse_ticks"] = 1
    mod.raw["pipeline_depth"] = 1
    if preset:
        lm = getattr(LM, preset)()
        lm = dataclasses.replace(lm, transformer=dataclasses.replace(
            lm.transformer, num_layers=TTS202501_LAYERS))
        mod = dataclasses.replace(mod, lm=lm)
    return mod


def _tts_voices(engine):
    """Seeded random voices: 5 speakers x 125 frames of the conditioning width."""
    import numpy as np

    from dsm_tpu_torch.server.voices import VoiceResolver

    rng = np.random.default_rng(5)
    n_rows = 125 * engine.cfg.speaker_cond_n_speakers
    engine.voices = VoiceResolver(preloaded={
        f"spk{i}": rng.standard_normal((n_rows, engine.cfg.speaker_cond_dim)).astype(np.float32)
        for i in range(8)})


def _tts_serve(engine, texts):
    """The TTS workload: 12 sessions (8 with voices) on ``texts``, wordless
    sessions in the other slots, then 4 more sessions with voices in slots
    freed by closed ones; every session ends, every word comes back, every
    frame is whole and finite -> ``(sessions, second, idle, frames)``."""
    sessions = {}
    for sid in range(12):
        _tts_open(engine, sid, f"spk{sid}" if sid < 8 else None, sessions, texts=texts)
    # Wordless sessions fill the other slots (pad or end-of-word each tick),
    # so the last 4 sessions can only land in slots freed by closed ones.
    idle = {}
    for i in range(engine.batch_size - engine.used_slots()):
        _tts_open(engine, 100 + i, None, idle, words=False)
    check(engine.used_slots() == engine.batch_size, "TTS slots left free")
    first = {sid: sessions[sid] for sid in range(12)}
    _tts_drive(engine, first)
    frame = engine.mimi_cfg.frame_size
    n_frames = _tts_verify(sessions, range(12), frame)
    freed = {sessions[sid]["drv"].slot for sid in range(4)}
    for sid in range(4):
        engine.close_session(sessions[sid]["drv"])
    second = {}
    for sid in range(12, 16):
        drv = _tts_open(engine, sid, f"spk{sid - 12}", second, texts=texts)
        check(drv.slot in freed, f"tts session {sid} did not reuse a freed slot")
    _tts_drive(engine, second)
    n_frames += _tts_verify(second, range(12, 16), frame)
    return sessions, second, idle, n_frames


def _tts_log(sessions, ticks):
    """Each session's events as comparable values (words with their times,
    frames as their bits) and the engine ticks served."""
    import numpy as np

    def ev(e):
        if hasattr(e, "pcm"):
            return ("audio", np.asarray(e.pcm, np.float32).tobytes())
        if hasattr(e, "text"):
            return ("word", e.text, e.start_s, e.stop_s)
        return (type(e).__name__,)

    return {sid: [ev(e) for e in s["events"]] for sid, s in sessions.items()}, ticks


def phase_tts(dev, card, preset=None):
    """The batched TTS engine from configs/config-tts-tpu-serving.toml;
    ``preset = "tts_202501"`` puts that model in place of the TOML's (no TOML
    of it is in the repository) and tags the lines ``[tts202501]``.  The
    engine runs the eager tick (``cuda_graph=False``), so that the wrappers
    count every launch, over the 16-session workload (``_tts_serve``) where
    the tag is in TTS_EAGER_SERVED, else over TTS_EAGER_TICKS ticks with every
    slot open -> ``(engine, launches, (events, ticks) or None)``."""
    import torch

    from dsm_tpu_torch.server import builder

    tag = "tts202501" if preset else "tts"
    per_tick = PER_TICK_TTS202501 if preset else PER_TICK_TTS
    counters = _tts_counters(per_tick)
    mod = _tts_module(tag, preset)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = builder.build_batched_tts(mod, dev, cuda_graph=False)  # counts every launch
    lm = engine.cfg.lm
    tcfg, dcfg = lm.transformer, lm.depformer.transformer
    shape = (tcfg.d_model, tcfg.num_layers, tcfg.num_heads, tcfg.hd, tcfg.context,
             lm.depformer.num_slices, dcfg.d_model, dcfg.num_layers, dcfg.num_heads,
             lm.depformer.low_rank_embeddings, engine.batch_size)
    if preset:
        check(shape == (2048, TTS202501_LAYERS, 32, 64, 500, 32, 1024, 6, 16, None, 64),
              f"not the tts_202501 B=64 config at {TTS202501_LAYERS} layers: {shape}")
        ring = engine.state["lm"]["t"]["layers"][0]["k"]
        check(ring.dtype == torch.int8 and tuple(ring.shape) == (64, 32, 512, 64),
              "not the int8 ring of tts_202501")
        check(tuple(engine._ca["k"].shape) == (TTS202501_LAYERS, 64, 32, 640, 64)
              and engine._ca["k"].dtype == torch.int8,
              f"the voice store is not ({TTS202501_LAYERS}, 64, 32, 640, 64) int8")
        check("low_rank" not in engine.params["lm"]["depformer"],
              "tts_202501's DepFormer has no low-rank embeddings")
    else:
        check(shape[:4] + shape[5:9] + shape[10:] == (2048, 16, 16, 128, 32, 1024, 4, 16, 64),
              "not the tts-1.6b B=64 config")
    check(engine.ca_quant and engine.cfg.kv_quant and engine._pcm_wire_i16,
          "not the serving profile (int8 voice store, int8 KV, int16 wire)")
    check(isinstance(engine.params["lm"]["transformer"][0]["in_proj_w"], dict)
          and isinstance(engine.params["lm"]["depformer"]["transformer"][0][0]["in_proj_w"],
                         dict), "LM weights not int8")
    check(engine.default_condition is not None, "no description condition")
    check(engine.mimi_cfg.transformer.num_layers == 8, "not the 8-layer Mimi decoder")
    check(per_tick["ca_decode_attend"] == per_tick["rope_qk"] == tcfg.num_layers
          and per_tick["rope_commit"] == engine.mimi_cfg.transformer.num_layers,
          "the launches per tick do not follow the config")
    _tts_voices(engine)
    torch.cuda.synchronize()
    print(f"[{tag}] engine built in {time.perf_counter() - t0:.3f} s (d={tcfg.d_model} "
          f"L={tcfg.num_layers} h={tcfg.num_heads}x{tcfg.hd} ctx {tcfg.context}, DepFormer "
          f"{lm.depformer.num_slices}x{dcfg.num_layers} d={dcfg.d_model} h={dcfg.num_heads}, "
          f"B=64, voice store int8 {tuple(engine._ca['k'].shape)}, int8 KV rings "
          f"{tuple(engine.state['lm']['t']['layers'][0]['k'].shape)} + W8A8, bf16 codec, int16 "
          f"wire, seeded random weights); memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak while building "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[{tag}] warmup {time.perf_counter() - t0:.3f} s", flush=True)

    for fn in counters.values():
        fn.launches = 0
    ticks0 = engine.step_count
    t0 = time.perf_counter()
    texts = TTS_SHORT_TEXTS if preset else TTS_TEXTS
    log = None
    if tag in TTS_EAGER_SERVED:
        sessions, second, idle, n_frames = _tts_serve(engine, texts)
        opened = [sessions[sid] for sid in range(4, 12)] + list(second.values()) \
            + list(idle.values())
    else:
        opened = {}
        for sid in range(engine.batch_size):  # 8 with voices, every slot open
            _tts_open(engine, sid, f"spk{sid}" if sid < 8 else None, opened, texts=texts)
        opened = list(opened.values())
        for _ in range(TTS_EAGER_TICKS):
            engine.tick()
    serve_s = time.perf_counter() - t0
    ticks = engine.step_count - ticks0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        check(n > 0 or per_tick[name] == 0, f"{name} never launched on the TTS path")
        check(n == per_tick[name] * ticks,
              f"{name}: {n} launches over {ticks} ticks, want {per_tick[name]} per tick")
    if tag in TTS_EAGER_SERVED:
        log = _tts_log({**sessions, **second}, ticks)
        words = sum(len(s["text"].split()) for s in list(sessions.values())
                    + list(second.values()))
        print(f"[{tag}] 16 sessions (8 + 4 reused slots with voices, 4 without), all done; "
              f"{words} words returned, {n_frames} frames of {engine.mimi_cfg.frame_size} "
              f"finite samples, {ticks} eager ticks in {serve_s:.3f} s with 64 slots open; "
              f"launches {launches} = per tick {per_tick}", flush=True)
    else:
        print(f"[{tag}] {engine.batch_size} sessions open (8 with voices), {ticks} eager ticks "
              f"in {serve_s:.3f} s; launches {launches} = per tick {per_tick} (the served "
              f"workload runs on the captured engine alone, [graph-{tag}])", flush=True)
    for sess in opened:
        engine.close_session(sess["drv"])
    check(engine.used_slots() == 0, "TTS slots still open")
    return engine, launches, log


def _with_w(plain):
    """A plain attention in a launch seam's place: the seam takes ``(..., pos,
    window, n_split)``, the plain version the position's ring row too."""
    return lambda *a: plain(*a[:-2], a[-3] % a[1].shape[2], *a[-2:])


@contextlib.contextmanager
def plain_seams():
    """Every kernel seam of the port takes its plain version, on CUDA tensors
    too: the reference that the path check holds the kernels' path to."""
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import qmm as QM
    from dsm_tpu_torch.ops import ring_kernels as RK

    saved = (RK.scale_commit, RK.ring_commit, RK.quantize_commit, RK.quantize_scale_commit,
             RK.rope_commit, RK.rope_qk, DA._launch, DA._ca_launch, DA._attend_launch,
             QM._launch)
    # ring_commit_plain also takes the scale rings (the split pipeline's commit).
    RK.scale_commit, RK.ring_commit = RK.scale_commit_plain, RK.ring_commit_plain
    RK.rope_commit, RK.rope_qk = RK.rope_commit_plain, RK.rope_qk_plain
    RK.quantize_commit = RK.quantize_commit_plain
    RK.quantize_scale_commit = RK.quantize_scale_commit_plain
    DA._launch, DA._ca_launch = _with_w(DA.decode_attend_commit_plain), DA.ca_decode_attend_plain
    DA._attend_launch = _with_w(DA.decode_attend_plain)
    QM._launch = lambda x2, wq, s, ksplit: QM.qmm_plain(x2, wq, s)
    try:
        yield
    finally:
        (RK.scale_commit, RK.ring_commit, RK.quantize_commit, RK.quantize_scale_commit,
         RK.rope_commit, RK.rope_qk, DA._launch, DA._ca_launch, DA._attend_launch,
         QM._launch) = saved


@contextlib.contextmanager
def attend_seam_errors(errs, launch=None):
    """Every ``decode_attend`` launch (through ``launch``, by default the
    seam as it stands) also runs the plain version on the same operands:
    ``errs`` collects each call's relative L2 of the kernel's output from it.
    The kernel's output goes on, so no layer's difference reaches the next."""
    from dsm_tpu_torch.ops import decode_attn as DA

    saved = DA._attend_launch
    launch = launch or saved

    def both(*args):
        y = launch(*args)
        errs.append(_rel(y, _with_w(DA.decode_attend_plain)(*args)))
        return y

    DA._attend_launch = both
    try:
        yield
    finally:
        DA._attend_launch = saved


def _clone(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _fill_rings(t_state, g, pos):
    """A transformer state whose rings are full and wrapped: every layer's K
    and V rows are random bf16 rows of unit spread through the port's own
    quantiser (``quantize_kv_rows``; ``quantize_kv_rows_packed4`` for uint8
    rings), every row valid, the tick counter at ``pos``: each written into
    the state's own tensors."""
    import torch

    from dsm_tpu_torch.ops import attention as A

    with torch.inference_mode():
        for layer in t_state["layers"]:
            b, h, c, row_bytes = layer["k"].shape
            packed4 = layer["k"].dtype == torch.uint8
            quantize = A.quantize_kv_rows_packed4 if packed4 else A.quantize_kv_rows
            rows = [torch.randn(b, h, c, 2 * row_bytes if packed4 else row_bytes, generator=g,
                                device=layer["k"].device).bfloat16() for _ in range(2)]
            for key, x in zip(("k", "v", "ks", "vs"), quantize(*rows)):
                layer[key].copy_(x)
        t_state["valid"].fill_(True)
        t_state["pos"].fill_(int(pos))  # in place: a captured tick reads this buffer


def phase_tts_path(engine, dev, tag="tts"):
    """The TTS path itself on the card: from clones of the engine's state
    (every slot active, voices in the store), the LM step with the voice
    cross-attention and the Mimi decode step run once through the kernels
    and once through their plain versions; their outputs must agree within
    PATH_RTOL (relative L2), the kernels counted on the first side only.  The
    LM step without the voice store must not: the bar sees the
    cross-attention."""
    import torch

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.models import mimi as MIMI

    cfg = engine.cfg
    n, batch = getattr(engine, "rows", 1), getattr(engine, "batch_size", 1)  # TtsEngine: 1
    g = torch.Generator(device=dev).manual_seed(13)
    text = torch.randint(4, 200, (n,), generator=g, device=dev, dtype=torch.int32)
    audio = torch.randint(0, 2048, (n, cfg.lm.audio_codebooks), generator=g, device=dev,
                          dtype=torch.int32)
    codes = torch.randint(0, 2048, (batch, engine.mimi_cfg.n_q, 1), generator=g,
                          device=dev, dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    dec_mask = torch.ones(batch, dtype=torch.bool, device=dev)

    def run(ca_kv):
        with torch.inference_mode():
            logits, hidden, _ = LM.step(cfg.lm, engine.params["lm"], _clone(engine.state["lm"]),
                                        text, audio, mask, ca_kv=ca_kv)
            pcm, _ = MIMI.decode_step(engine.mimi_cfg, engine.mimi_params,
                                      _clone(engine.mimi_state), codes, dec_mask)
        return {"hidden": hidden, "text_logits": logits, "pcm": pcm}

    counters = _tts_counters({**PER_TICK_TTS, **PER_TICK_TTS202501})
    for fn in counters.values():
        fn.launches = 0
    got = run(engine._ca)
    launched = {k: fn.launches for k, fn in counters.items()}
    with plain_seams():
        want = run(engine._ca)
        no_voice = run(None)
    check(all(launched[k] > 0 for k in ("rope_qk", "ca_decode_attend", "rope_commit"))
          and {k: fn.launches for k, fn in counters.items()} == launched,
          f"path check: the kernels' side launched {launched}, the plain side "
          f"{ {k: fn.launches - launched[k] for k, fn in counters.items()} }")
    rel = {k: _rel(got[k], want[k]) for k in got}
    voice = _rel(no_voice["hidden"], want["hidden"])
    for k, r in rel.items():
        check(bool(torch.isfinite(got[k]).all()), f"path check: {k} not finite")
        check(r <= PATH_RTOL, f"path check: {k} through the kernels {r!r} from the plain path")
    check(voice > PATH_RTOL, f"path check: the voice moves the hidden state only {voice!r}")
    print(f"[{tag}-path] {n} active rows, kernels against plain versions from one state: "
          f"relative L2 hidden {rel['hidden']!r}, text logits {rel['text_logits']!r}, "
          f"Mimi pcm {rel['pcm']!r} (bar {PATH_RTOL}); without the voice store the hidden "
          f"state moves {voice!r}; kernels launched { {k: n for k, n in launched.items() if n} } "
          f"on the kernels' side, none on the plain side", flush=True)


def phase_tts_times(engine, dev, card, tag="tts"):
    """Every slot active: where the eager tick's time goes (a kernel profile
    of one tick after 2), then the path check (:func:`phase_tts_path`).  The
    eager tick's host times and its three parts' are PERF.md section 5's; the
    captured tick is timed in ``[graph-tts]``."""
    b = engine.batch_size
    long_text = " ".join(TTS_TEXTS * 4)
    drivers = []
    for i in range(b):
        drv = engine.open_session(lambda ev: None, voice_ca=engine.voice_kv(f"spk{i % 8}"),
                                  seed=500 + i, text_temperature=0.6, audio_temperature=0.8)
        enc, _ = engine.encode_words(long_text, inserted_bos=False)
        drv.feed_words(enc)
        drivers.append(drv)
    for _ in range(2):
        check(engine.tick(), "TTS tick with 64 slots stepped nothing")
    rows, wall_us = _profile(engine.tick, 1)
    _print_profile(f"{tag}-profile", "", rows, wall_us, 1, "tick", card, 15)
    phase_tts_path(engine, dev, tag)
    for drv in drivers:
        engine.close_session(drv)


# ---------------------------------------------------------------------------
# The TTS tick as one captured CUDA graph
# ---------------------------------------------------------------------------

# Ticks the captured tick is held to the eager tick over, from a state whose
# LM ring and Mimi decoder ring (256 rows, 2 a tick) sit 40 rows before a
# wrap; the whole state is compared every GRAPH_TTS_CHECK_EVERY ticks.
GRAPH_TICKS = {"graph-tts": 48, "graph-tts202501": 48}  # from 40 rows before the wraps
# Ticks timed after a warm-up by _tts_graph_times and _duplex_graph_times (the
# eager ticks take 0.3-1 s each).
TICKS_WARM, TICKS_TIMED = 5, 30
GRAPH_TTS_CHECK_EVERY = 40


def _tts_graph_traffic(b, ticks, seed):
    """``ticks`` engine inputs from a seed: slots open (with a reset) and close
    along the way, an open slot steps 9 ticks in 10 (partial masks), and
    each takes one of the three constraint modes with a word-piece token."""
    import numpy as np

    rng = np.random.default_rng(seed)
    active = rng.uniform(size=b) < 0.8
    for i in range(ticks):
        opening = ~active & (rng.uniform(size=b) < 0.1)
        closing = active & (rng.uniform(size=b) < 0.025)
        reset = opening | (active & (i == 0))
        active = (active | opening) & ~closing
        mask = active & (rng.uniform(size=b) < 0.9)
        modes = rng.integers(0, 3, size=b).astype(np.int32)
        toks = rng.integers(4, 8000, size=b).astype(np.int32)
        yield modes, toks, mask, reset


def _tts_graph_times(engine, tag, what, card, rope_per_tick):
    """The engine's device tick (``_invoke_step``: staging or upload, the
    tick, the fetch) with every slot active and choosing pad or end-of-word:
    host ms a tick (median, min, max over TICKS_TIMED after TICKS_WARM), the
    device's busy share, kernel ms and device launches a tick from a profile of 2
    ticks, and the peak memory (reserved, a captured graph's private pool
    included, and allocated) since the caller reset it."""
    import numpy as np
    import torch

    from dsm_tpu_torch.sessions import tts as TTS

    b = engine.batch_size
    modes = np.full(b, TTS.ALLOW_PAD_OR_EPAD, np.int32)
    toks = np.zeros(b, np.int32)
    on, off = np.ones(b, bool), np.zeros(b, bool)
    times = []
    with torch.inference_mode():
        engine._invoke_step(modes, toks, on, on)  # every slot fresh
        for i in range(TICKS_WARM + TICKS_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed = engine._invoke_step(modes, toks, on, off)
            torch.cuda.synchronize()
            if i >= TICKS_WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        check(bool((packed[b:2 * b] == 1 + TICKS_WARM + TICKS_TIMED).all()),
              f"{tag}: the slots did not step")
        rows, wall_us = _profile(lambda: engine._invoke_step(modes, toks, on, off), 2,
                                 rope_launches=2 * rope_per_tick)
    kernel_ms = _print_profile(f"{tag}-profile", what, rows, wall_us, 2, "tick", card, 6)
    launches = sum(c for _, _, c in rows) / 2
    peak = torch.cuda.max_memory_reserved() / 1e9
    peak_alloc = torch.cuda.max_memory_allocated() / 1e9
    tick_ms = statistics.median(times)
    busy = kernel_ms / (wall_us / 2 / 1e3)
    print(f"[{tag}] {what}engine tick, {b} slots active: median {tick_ms!r} ms, min "
          f"{min(times)!r}, max {max(times)!r} over {TICKS_TIMED} after {TICKS_WARM} "
          f"warm-up; device busy "
          f"{busy!r}; {launches:.0f} device launches a tick; kernels {kernel_ms!r} ms a tick; "
          f"peak memory {peak:.2f} GB reserved ({peak_alloc:.2f} GB allocated); card {card}",
          flush=True)
    return {"step_ms": tick_ms, "min_ms": min(times), "max_ms": max(times), "busy": busy,
            "launches": launches, "kernel_ms": kernel_ms, "peak_gb": peak,
            "peak_alloc_gb": peak_alloc}


def _first_difference(got, want):
    """Where two serve logs (``_tts_log``) first differ, for the message."""
    if got[1] != want[1]:
        return f"{got[1]} ticks against {want[1]}"
    for sid in want[0]:
        a, b = got[0].get(sid, []), want[0][sid]
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return f"session {sid}, event {i}: {x[:2]} against {y[:2]}"
        if len(a) != len(b):
            return f"session {sid}: {len(a)} events against {len(b)}"
    return "none"


def phase_graph_tts(dev, card, eager_log, preset=None):
    """The TTS tick as one captured CUDA graph: the engine as
    ``build_batched_tts`` makes it on CUDA (``cuda_graph`` left at its
    default), its tick captured by ``warmup()``.  (1) It serves the TTS
    workload (``_tts_serve``: every session ends, every word comes back,
    every frame whole and finite) and, given the eager engine's
    ``eager_log`` of it, from the same weights and start, holds each
    session's events (words with their times, every frame bit for bit) and
    the ticks to it; the kernels counted over its warm-up and capture (3 x
    per tick), none over the replays.  (2) Its tick timed.  (3)
    From a state whose LM and Mimi decoder rings sit 40 rows before a wrap,
    the eager tick (``TTS.step`` + ``MIMI.decode_step`` on a clone of the
    state, the engine's params and voice store shared) beside the replay over
    ``GRAPH_TICKS`` ticks of traffic (slots opened, closed and reset, partial
    masks, a voice written and a pad overwrite between replays): the packed
    array of every tick bit for bit, the whole state every
    ``GRAPH_TTS_CHECK_EVERY`` ticks and at the end."""
    import copy

    import numpy as np
    import torch

    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.sessions import tts as TTS

    tag = "graph-tts202501" if preset else "graph-tts"
    per_tick = PER_TICK_TTS202501 if preset else PER_TICK_TTS
    counters = _tts_counters(per_tick)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mod = _tts_module(tag, preset)
    t0 = time.perf_counter()
    engine = builder.build_batched_tts(mod, dev)
    check(engine.cuda_graph and engine._graph is None, f"{tag}: the tick is not captured "
          f"by default on CUDA")
    _tts_voices(engine)
    engine.warmup()  # two ticks on the side stream, then the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    check(engine._graph is not None, f"{tag}: no graph captured")

    ticks0 = engine.step_count
    t0 = time.perf_counter()
    sessions, second, idle, n_frames = _tts_serve(
        engine, TTS_SHORT_TEXTS if preset else TTS_TEXTS)
    serve_s = time.perf_counter() - t0
    log = _tts_log({**sessions, **second}, engine.step_count - ticks0)
    launches = {name: fn.launches for name, fn in counters.items()}
    if eager_log is not None:
        check(log == eager_log, f"{tag}: the captured engine's events differ from the eager "
              f"engine's: first at {_first_difference(log, eager_log)}")
    want = {name: 3 * n for name, n in per_tick.items()}
    check(launches == want, f"{tag}: launches {launches}, want {want} (warm-up + capture)")
    for s in [sessions[sid] for sid in range(4, 12)] + list(second.values()) \
            + list(idle.values()):
        engine.close_session(s["drv"])
    n_words = sum(1 for evs in log[0].values() for e in evs if e[0] == "word")
    held = (f"each session's events (words with their times, every frame bit for bit) and "
            f"the ticks equal to the eager engine's serve of [{tag[6:]}]"
            if eager_log is not None else "no eager serve to hold them to")
    print(f"[{tag}] built and captured in {capture_s:.2f} s; served 16 sessions (8 + 4 "
          f"reused slots with voices, 4 without) in {log[1]} ticks ({serve_s:.3f} s): "
          f"{n_words} word events and {n_frames} frames, every session ended, {held}; kernel "
          f"launches counted over its warm-up and capture {launches} = 3 x per tick, none on "
          f"replay (the replay against the eager tick below)", flush=True)

    rope = per_tick["rope_qk"] + per_tick["rope_commit"]
    numbers = {"launches": launches,
               "graph": _tts_graph_times(engine, tag, "captured: ", card, rope)}

    b = engine.batch_size
    g = torch.Generator(device=dev).manual_seed(21)
    lm_t, dec_t = engine.state["lm"]["t"], engine.mimi_state["dec_t"]
    lm_ring, dec_ring = lm_t["valid"].shape[1], dec_t["valid"].shape[1]
    _fill_rings(lm_t, g, 3 * lm_ring - 40)
    dec_t["pos"].fill_(3 * dec_ring - 40)
    rng = np.random.default_rng(43)
    engine._text_temp[:] = rng.uniform(0.0, 1.0, b)
    engine._audio_temp[:] = rng.uniform(0.0, 1.0, b)
    engine._seeds[:] = rng.integers(0, 2**32, b)
    ref = copy.copy(engine)  # the eager tick; params, voice store and host arrays shared
    ref.cuda_graph = False
    ref.state, ref.mimi_state = _clone(engine.state), _clone(engine.mimi_state)
    ticks = GRAPH_TICKS[tag]
    voice = engine.voice_kv("spk6")
    resets = partial = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i, (modes, toks, mask, reset) in enumerate(_tts_graph_traffic(b, ticks, seed=43)):
            resets += int(reset.sum())
            partial += int(0 < mask.sum() < b)
            if i == ticks // 3:  # between replays, into the store both read
                engine._apply_voice_writes([(5, voice)])
            if i == ticks // 2:
                slots = torch.as_tensor(engine._rows(mask), device=dev)
                for e in (engine, ref):
                    TTS.overwrite_last_text_token_in_place(e.state, engine.cfg.text_pad_token,
                                                           slots)
            got = engine._invoke_step(modes, toks, mask, reset)
            want_packed = ref._invoke_step(modes, toks, mask, reset)
            check(np.array_equal(got, want_packed),
                  f"{tag}: tick {i}: the replay's packed array differs from the eager tick's")
            if (i + 1) % GRAPH_TTS_CHECK_EVERY == 0 or i + 1 == ticks:
                diff = (_tree_diff(engine.state, ref.state)
                        + _tree_diff(engine.mimi_state, ref.mimi_state, "/mimi"))
                check(not diff, f"{tag}: tick {i}: the state differs at {diff[:5]}")
    lm_pos, dec_pos = int(ref.state["lm"]["t"]["pos"]), int(ref.mimi_state["dec_t"]["pos"])
    check(lm_pos > 3 * lm_ring and dec_pos > 3 * dec_ring, f"{tag}: the rings did not wrap")
    decoded = int(np.asarray(got[2 * b:3 * b]).sum())
    print(f"[{tag}] {ticks} ticks of {engine.cfg.lm.transformer.num_layers} layers from one "
          f"state, replay against the eager TTS.step + MIMI.decode_step: the packed array "
          f"(text tokens, steps, decode mask, int16 pcm) bit for bit at every tick, the whole "
          f"state (LM rings, scale rings, valid, pos, token buffers, counters, Mimi decoder "
          f"ring and carries) every {GRAPH_TTS_CHECK_EVERY} ticks and at the end; {resets} "
          f"slot resets, {partial} partial masks, a voice written at tick {ticks // 3} and a "
          f"pad overwrite at {ticks // 2}; LM ring of {lm_ring} rows at tick {lm_pos}, Mimi "
          f"decoder ring of {dec_ring} at {dec_pos}; {decoded} frames decoded at the last "
          f"tick; {time.perf_counter() - t0:.1f} s", flush=True)
    del engine, ref
    torch.cuda.empty_cache()
    return numbers


# ---------------------------------------------------------------------------
# Phase 7: the batched full-duplex dialogue path
# ---------------------------------------------------------------------------


def _duplex_counters():
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import ring_kernels as RK

    return {"rope_qk": RK.rope_qk, "quantize_commit": RK.quantize_commit,
            "decode_attend": DA.decode_attend, "rope_commit": RK.rope_commit,
            "ring_commit": RK.ring_commit, "quantize_scale_commit": RK.quantize_scale_commit,
            "decode_attend_commit": DA.decode_attend_commit,
            "ring_commit_q": RK.ring_commit_q, "scale_commit": RK.scale_commit}


def _duplex_open(engine, sid, seconds, sessions, asr_delay=0):
    events = []
    drv = engine.open_session(events.append, asr_delay_in_tokens=asr_delay)
    check(drv is not None, "no free duplex slot")
    frame = engine.mimi_cfg.frame_size
    pcm = _pcm(sid, seconds, frame)
    drv.push_pcm(pcm)
    drv.end_input()
    sessions[sid] = {"drv": drv, "events": events, "frames": len(pcm) // frame,
                     "asr_delay": asr_delay}
    return drv


def _duplex_drive(engine, sessions, limit_s=300.0):
    from dsm_tpu_torch.server.duplex_batched import DuplexDoneEvent

    deadline = time.monotonic() + limit_s
    while not all(s["events"] and isinstance(s["events"][-1], DuplexDoneEvent)
                  for s in sessions.values()):
        check(time.monotonic() < deadline, "duplex dialogues did not finish")
        engine.tick()


def _duplex_verify(engine, sessions, sids):
    import numpy as np

    from dsm_tpu_torch.server.duplex_batched import (DuplexAudioEvent, DuplexDoneEvent,
                                                     DuplexTextEvent)

    frame = engine.mimi_cfg.frame_size
    n_audio = n_text = 0
    for sid in sids:
        s = sessions[sid]
        evs = s["events"]
        check(isinstance(evs[-1], DuplexDoneEvent)
              and sum(isinstance(e, DuplexDoneEvent) for e in evs) == 1,
              f"dialogue {sid}: does not end in one Done")
        # Every pushed frame stepped, and from step 0: a reused slot's
        # counter restarted.
        check(s["drv"].steps == s["frames"],
              f"dialogue {sid}: {s['drv'].steps} steps for {s['frames']} frames")
        audio = [e.pcm for e in evs if isinstance(e, DuplexAudioEvent)]
        texts = [e.text for e in evs if isinstance(e, DuplexTextEvent)]
        for pcm in audio:
            check(pcm.shape == (frame,) and pcm.dtype == np.float32
                  and bool(np.isfinite(pcm).all()), f"dialogue {sid}: bad frame {pcm.shape}")
        if s["asr_delay"] > 0:
            check(not audio, f"dialogue {sid}: a text-only dialogue got audio")
            check(len(texts) > 0, f"dialogue {sid}: a text-only dialogue got no text")
        else:
            # The first frame completes once the acoustic delay has passed.
            check(len(audio) == s["frames"] - engine.cfg.acoustic_delay,
                  f"dialogue {sid}: {len(audio)} audio frames for {s['frames']} steps")
            first_audio = next(i for i, e in enumerate(evs) if isinstance(e, DuplexAudioEvent))
            check(all(isinstance(e, DuplexTextEvent) for e in evs[:first_audio]),
                  f"dialogue {sid}: audio order")
        n_audio += len(audio)
        n_text += len(texts)
    return n_audio, n_text


def _duplex_module(tag, kv_bits, depth):
    """configs/config-duplex-tpu-serving.toml with ``kv_bits`` and
    ``pipeline_depth`` as given (printed where they differ from the file)."""
    from dsm_tpu_torch.server import config as CFG

    path = os.path.join(ROOT, "configs", "config-duplex-tpu-serving.toml")
    mod = CFG.Config.load(path).modules["duplex"]
    changed = [f"{key} {mod.raw[key]} -> {value}"
               for key, value in (("pipeline_depth", depth), ("kv_bits", kv_bits))
               if mod.raw[key] != value]
    print(f"[{tag}] {os.path.relpath(path, ROOT)}: "
          f"{', '.join(changed) if changed else 'as shipped'}; every other key as in the file",
          flush=True)
    mod.raw["pipeline_depth"] = depth
    mod.raw["kv_bits"] = kv_bits
    return mod


def _check_duplex_engine(engine, kv_bits):
    """The engine is s2s-2b at B=24 with the serving profile and the rings
    the kernel cases hold."""
    import torch

    lm = engine.cfg.lm
    tcfg, dcfg = lm.transformer, lm.depformer.transformer
    check((tcfg.d_model, tcfg.num_layers, tcfg.num_heads, tcfg.hd, tcfg.context,
           lm.audio_codebooks, lm.depformer.num_slices, dcfg.d_model, dcfg.num_layers,
           dcfg.num_heads, engine.batch_size, engine.cfg.generated_audio_codebooks,
           engine.cfg.input_audio_codebooks)
          == (2560, 24, 20, 128, 3000, 32, 16, 1024, 6, 16, 24, 16, 16),
          "not the s2s-2b B=24 config")
    ring = engine.state["lm"]["t"]["layers"][0]
    want_ring = (torch.int8, (24, 20, 3072, 128)) if kv_bits == 8 else \
        (torch.uint8, (24, 20, 3072, 64))
    check(engine.kv_quant and engine.kv_bits == kv_bits
          and (ring["k"].dtype, tuple(ring["k"].shape)) == want_ring
          and tuple(ring["ks"].shape) == (24, 20, 3072),
          f"not the {want_ring[0]} ring of s2s-2b")
    check(isinstance(engine.params["lm"]["transformer"][0]["in_proj_w"], dict)
          and isinstance(engine.params["lm"]["depformer"]["transformer"][0][0]["in_proj_w"],
                         dict), "LM weights not int8")
    check(engine.mimi_cfg.n_q == 16 and engine.mimi_cfg.transformer.num_layers == 8
          and engine._mimi_dtype == torch.bfloat16, "not the 16-codebook bf16 codec")
    for rings in (engine.enc_state["enc_t"]["layers"], engine.dec_state["dec_t"]["layers"]):
        check(all(tuple(r[kv].shape) == DUPLEX_MIMI_RING and r[kv].dtype == torch.bfloat16
                  for r in rings for kv in ("k", "v")),
              "the codec's rings are not the shape the rope_commit cases hold")
    check(PER_TICK_DUPLEX["decode_attend"] == PER_TICK_DUPLEX["rope_qk"] == tcfg.num_layers
          and PER_TICK_DUPLEX["rope_commit"] == 2 * engine.mimi_cfg.transformer.num_layers,
          "PER_TICK_DUPLEX does not follow the config")
    return ring


def _duplex_serve(engine, n_first, n_second, base_s):
    """``n_first`` dialogues (two text-only, with an ASR delay), idle
    connections in the other slots, driven to their ends and checked; then
    ``n_second`` more in the slots of the first ones closed.  Returns the
    dialogues, the idle drivers and the audio and text events' counts."""
    sessions = {}
    for sid in range(n_first):
        _duplex_open(engine, sid, base_s + (sid % 5) / 4.0, sessions,
                     asr_delay=6 if sid in (3, 7) else 0)
    # Idle connections fill the other slots, so the next dialogues can only
    # land in slots freed by closed ones: the reset path.
    idle = [engine.open_session(lambda ev: None)
            for _ in range(engine.batch_size - engine.used_slots())]
    check(engine.used_slots() == engine.batch_size and engine.open_session(print) is None,
          "duplex slots left free")
    _duplex_drive(engine, sessions)
    n_audio, n_text = _duplex_verify(engine, sessions, range(n_first))
    freed = {sessions[sid]["drv"].slot for sid in range(n_second)}
    for sid in range(n_second):
        engine.close_session(sessions[sid]["drv"])
    for sid in range(n_first, n_first + n_second):
        drv = _duplex_open(engine, sid, base_s, sessions,
                           asr_delay=5 if sid == n_first + 1 else 0)
        check(drv.slot in freed, f"dialogue {sid} did not reuse a freed slot")
    second = {sid: sessions[sid] for sid in range(n_first, n_first + n_second)}
    _duplex_drive(engine, second)
    a2, t2 = _duplex_verify(engine, second, second)
    return sessions, idle, n_audio + a2, n_text + t2


def _duplex_log(sessions, ticks):
    """Each dialogue's events (kind, text, the pcm's bytes) and the ticks
    dispatched: what two engines serving one workload must agree on."""
    return ({sid: [(type(e).__name__, getattr(e, "text", None),
                    e.pcm.tobytes() if hasattr(e, "pcm") else None) for e in s["events"]]
             for sid, s in sessions.items()}, ticks)


def phase_duplex(dev, card, kv_bits=8):
    """The dialogue engine from configs/config-duplex-tpu-serving.toml,
    eager (``cuda_graph=False``, so that the wrappers count every launch)
    at ``pipeline_depth`` 1: the reference the captured engine of
    ``[graph-duplex]`` is held to.  ``kv_bits = 4`` changes the file's 8
    (packed-int4 rings), serves half as many dialogues and tags the lines
    ``[duplex-kv4]``.  Returns the engine, the launches and the served
    workload's log."""
    import torch

    from dsm_tpu_torch.server import builder

    tag = "duplex" if kv_bits == 8 else "duplex-kv4"
    n_first, n_second = (12, 4) if kv_bits == 8 else (6, 2)
    counters = _duplex_counters()
    mod = _duplex_module(tag, kv_bits, 1)
    t0 = time.perf_counter()
    engine = builder.build_duplex(mod, dev, cuda_graph=False)
    ring = _check_duplex_engine(engine, kv_bits)
    torch.cuda.synchronize()
    role = " (the reference of [graph-duplex])" if kv_bits == 8 else ""
    print(f"[{tag}] eager engine{role} built in "
          f"{time.perf_counter() - t0:.3f} s (s2s-2b d=2560 L=24 "
          f"h=20x128 ctx 3000, 16+16 codebooks, DepFormer 16x6 d=1024 h=16, B=24, "
          f"{ring['k'].dtype} rings {tuple(ring['k'].shape)}, int8 weights + W8A8, bf16 codec, "
          f"seeded random weights); memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[{tag}] warmup {time.perf_counter() - t0:.3f} s", flush=True)

    for fn in counters.values():
        fn.launches = 0
    ticks0 = engine.step_count
    t0 = time.perf_counter()
    base_s = 2.0 if kv_bits == 8 else 1.5  # shorter dialogues in the int4 leg
    sessions, idle, n_audio, n_text = _duplex_serve(engine, n_first, n_second, base_s)
    serve_s = time.perf_counter() - t0
    ticks = engine.step_count - ticks0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        check(n == PER_TICK_DUPLEX[name] * ticks,
              f"{name}: {n} launches over {ticks} ticks, want {PER_TICK_DUPLEX[name]} "
              f"per tick")
        check(n > 0 or PER_TICK_DUPLEX[name] == 0,
              f"{name} never launched on the duplex path")
    frames = sum(s["frames"] for s in sessions.values())
    text_only = sum(s["asr_delay"] > 0 for s in sessions.values())
    print(f"[{tag}] {n_first + n_second} dialogues ({n_first} + {n_second} in reused slots; "
          f"{text_only} text-only with an ASR delay), "
          f"all done; {frames} frames pushed and stepped, {n_audio} audio frames of "
          f"{engine.mimi_cfg.frame_size} finite samples (none before the acoustic delay, "
          f"none for text-only dialogues), {n_text} text events, {ticks} ticks in "
          f"{serve_s:.3f} s with 24 slots open; launches {launches} = per tick "
          f"{PER_TICK_DUPLEX}", flush=True)
    for sid in range(n_second, n_first + n_second):
        engine.close_session(sessions[sid]["drv"])
    for drv in idle:
        engine.close_session(drv)
    check(engine.used_slots() == 0, "duplex slots still open")
    return engine, launches, _duplex_log(sessions, ticks)


def phase_duplex_path(engine, dev, tag="duplex", mimi=True, full=False):
    """The duplex steps on the card: from clones of the engine's state,
    once through the kernels and once through their plain versions.  The LM
    step (the split ring pipeline): hidden state and text logits must agree
    within PATH_RTOL (relative L2); with the ring's history masked out (an
    empty validity bitmap) they must not: the bar sees the attention.  The
    Mimi encode and decode steps (``rope_commit`` at T=2, bit for bit the
    plain version): codes, pcm and every ring equal.  Each side's launches
    are counted: 24 + 24 + 24 through the kernels, none through the plain
    versions; and each ``decode_attend`` launch is held to its plain version
    on the same operands (SEAM_RTOL).  ``full``: the engine's rings are full
    (see :func:`_fill_rings`), the outputs' bar is FULL_RING_RTOL, and a
    bit-identical pair fails."""
    import torch

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.models import mimi as MIMI
    from dsm_tpu_torch.ops import ring_kernels as RK

    cfg, n = engine.cfg, engine.batch_size
    g = torch.Generator(device=dev).manual_seed(17)
    text = torch.randint(4, 200, (n,), generator=g, device=dev, dtype=torch.int32)
    audio = torch.randint(0, 2048, (n, cfg.lm.audio_codebooks), generator=g, device=dev,
                          dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    pos = int(engine.state["lm"]["t"]["pos"])  # for the lines below: read outside the step
    seen = int(engine.state["lm"]["t"]["valid"].sum(dim=1).min())

    counters = _duplex_counters()  # the kernels' wrappers, not the seams' plain versions

    def run(forget=False):
        state = _clone(engine.state["lm"])
        if forget:
            state["t"]["valid"].zero_()
        before = {name: fn.launches for name, fn in counters.items()}
        with torch.inference_mode():
            logits, hidden, _ = LM.step(cfg.lm, engine.params["lm"], state, text, audio, mask)
        launched = {name: fn.launches - before[name] for name, fn in counters.items()}
        return {"hidden": hidden, "text_logits": logits}, launched

    seam = []
    with attend_seam_errors(seam):
        got, launched = run()
    with plain_seams():
        want, launched_plain = run()
        empty = run(forget=True)[0]
    layers = cfg.lm.transformer.num_layers
    check(len(seam) == layers and max(seam) <= SEAM_RTOL,
          f"duplex path check: decode_attend is {seam!r} from its plain version on the "
          f"layers' own operands")
    check(launched == {**dict.fromkeys(counters, 0), "rope_qk": layers,
                       "quantize_commit": layers, "decode_attend": layers},
          f"duplex path check: the kernels' step launched {launched}")
    check(not any(launched_plain.values()),
          f"duplex path check: the plain step launched {launched_plain}")
    rel = {k: _rel(got[k], want[k]) for k in got}
    history = _rel(empty["hidden"], want["hidden"])
    bar = FULL_RING_RTOL if full else PATH_RTOL
    packed = engine.state["lm"]["t"]["layers"][0]["k"].dtype == torch.uint8
    if full and packed:  # the step's only kernels: decode_attend alone, with quantize_commit
        bar = Q4_ALONE_FULL_RTOL["duplex-kv4"]
    for k, r in rel.items():
        check(bool(torch.isfinite(got[k]).all()), f"duplex path check: {k} not finite")
        check(r <= bar, f"duplex path check: {k} through the kernels {r!r} from the plain path")
    check(history > PATH_RTOL,
          f"duplex path check: the ring's history moves the hidden state only {history!r}")
    # Two sums of thousands of rows in different orders do not round alike:
    # over full rings an identical pair means both sides ran the same code.
    check(not full or min(rel.values()) > 0,
          "duplex path check: kernels and plain versions bit-identical over full rings")
    print(f"[{tag}-path] {n} active rows at tick {pos} (every slot with at least {seen} "
          f"valid ring rows), LM step through rope_qk + quantize_commit + decode_attend "
          f"({layers} launches each; none in the plain step; rope_qk and quantize_commit are "
          f"bit for bit their plain versions, so this is decode_attend alone) against their "
          f"plain versions from one state: relative L2 hidden {rel['hidden']!r}, text "
          f"logits {rel['text_logits']!r} (bar {bar}); each layer's decode_attend from its "
          f"plain version on the same operands at most {max(seam)!r} (bar {SEAM_RTOL}); with "
          f"the ring's history masked the hidden state moves {history!r}", flush=True)

    if not mimi:  # the codec does not depend on the LM's rings
        return
    pcm = (torch.randn(n, 1, engine.mimi_cfg.frame_size, generator=g, device=dev)
           * 0.1).to(engine._mimi_dtype)
    codes = torch.randint(0, 2048, (n, engine.mimi_cfg.n_q, 1), generator=g, device=dev,
                          dtype=torch.int32)

    def run_mimi():
        with torch.inference_mode():
            enc, s_enc = MIMI.encode_step(engine.mimi_cfg, engine.mimi_params,
                                          _clone(engine.enc_state), pcm, mask)
            out, s_dec = MIMI.decode_step(engine.mimi_cfg, engine.mimi_params,
                                          _clone(engine.dec_state), codes, mask)
        rings = [r[kv] for r in s_enc["enc_t"]["layers"] + s_dec["dec_t"]["layers"]
                 for kv in ("k", "v")]
        return enc, out, rings

    before = {name: fn.launches for name, fn in counters.items()}
    enc, out, rings = run_mimi()
    launched = {name: fn.launches - before[name] for name, fn in counters.items()}
    before = {name: fn.launches for name, fn in counters.items()}
    with plain_seams():
        enc_p, out_p, rings_p = run_mimi()
    launched_plain = {name: fn.launches - before[name] for name, fn in counters.items()}
    check(launched == {**dict.fromkeys(counters, 0),
                       "rope_commit": PER_TICK_DUPLEX["rope_commit"]},
          f"duplex path check: the two Mimi steps launched {launched}")
    check(not any(launched_plain.values()),
          f"duplex path check: the plain Mimi steps launched {launched_plain}")
    check(bool(torch.isfinite(out).all()) and float(out.float().abs().max()) > 0,
          "duplex path check: Mimi pcm not finite or all zero")
    check(torch.equal(enc, enc_p), "duplex path check: Mimi codes differ from the plain path")
    check(torch.equal(out, out_p), "duplex path check: Mimi pcm differs from the plain path")
    check(all(torch.equal(a, b) for a, b in zip(rings, rings_p)) and len(rings) == 32,
          "duplex path check: a codec ring differs from the plain path")
    print(f"[duplex-path] Mimi encode_step and decode_step at {n} rows, rings "
          f"{DUPLEX_MIMI_RING} at tick {int(engine.enc_state['enc_t']['pos'])}: "
          f"{launched['rope_commit']} rope_commit launches (T=2; none in the plain steps) "
          f"against the plain versions from one state: codes "
          f"{tuple(enc.shape)} equal, pcm {tuple(out.shape)} equal, 32 rings bit for bit",
          flush=True)


def _duplex_ticks(engine, n, warm):
    """``n`` ticks after ``warm`` with every slot fed a frame -> their ms."""
    frame = engine.mimi_cfg.frame_size
    ticks = []
    for i in range(n + warm):
        for drv in engine.slots:
            drv.push_pcm(_pcm(i, 0.08, frame))
        t0 = time.perf_counter()
        check(engine.tick(), "duplex tick with 24 slots stepped nothing")
        if i >= warm:
            ticks.append((time.perf_counter() - t0) * 1e3)
    return ticks


def _profile_ticks(engine, n, tag, what, card):
    frame = engine.mimi_cfg.frame_size
    for drv in engine.slots:
        drv.push_pcm(_pcm(99, 0.08 * n, frame))
    rows, wall_us = _profile(engine.tick, n)
    _print_profile(tag, f"{what}: ", rows, wall_us, n, "tick", card, 14)


def phase_duplex_times(engine, dev, card, tag="duplex", brief=False):
    """Every slot active: where the eager tick's time goes over short rings
    (a kernel profile of one tick after 2), the path check, then the same
    over full rings (the profile and the path check once more).  ``brief``:
    no codec path check.  The eager tick's host times and its parts' are
    PERF.md section 5's; the captured tick is timed in ``[graph-duplex]``.
    Returns the peak memory of the first ticks in GB."""
    import torch

    b = engine.batch_size
    opened = [engine.open_session(lambda ev: None) for _ in range(b)]
    check(all(d is not None for d in opened), "no free duplex slot for the profile")
    torch.cuda.reset_peak_memory_stats()
    _duplex_ticks(engine, 0, 2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}-times] 24 slots active (rings hold "
          f"{int(engine.state['lm']['t']['pos'])} rows): peak memory {peak_gb:.2f} GB; "
          f"card {card}", flush=True)
    _profile_ticks(engine, 1, f"{tag}-profile", "24 slots, short rings", card)
    phase_duplex_path(engine, dev, tag, mimi=not brief)

    # Full rings: a dialogue past 3000 frames (4 minutes).  The tick counter
    # is moved there, every row marked valid and every row's scales set, so
    # each decode_attend reads the K and V of its whole window (a row whose
    # probability times v_scale rounds to 0 is skipped; the int8 rows hold
    # what the short run left: zeros mostly).
    engine.state["lm"]["t"]["pos"] = torch.full_like(engine.state["lm"]["t"]["pos"], 5000)
    with torch.inference_mode():  # the bitmap was made inside the step
        engine.state["lm"]["t"]["valid"].fill_(True)
        for layer in engine.state["lm"]["t"]["layers"]:
            layer["ks"].fill_(0.01)
            layer["vs"].fill_(0.01)
    _duplex_ticks(engine, 0, 2)
    _profile_ticks(engine, 1, f"{tag}-profile", "24 slots, full rings", card)
    # The path check once more over full, wrapped rings of real quantised rows.
    _fill_rings(engine.state["lm"]["t"], torch.Generator(device=dev).manual_seed(29),
                engine.state["lm"]["t"]["pos"])
    phase_duplex_path(engine, dev, f"{tag}-full", mimi=False, full=True)
    for drv in opened:
        engine.close_session(drv)
    return peak_gb


# ---------------------------------------------------------------------------
# The duplex tick as one captured CUDA graph, with dispatch-ahead
# ---------------------------------------------------------------------------

# Ticks the captured duplex tick is held to the eager tick over, from a state
# whose LM ring (3,072 rows, one a tick) sits half as many rows and the codec
# rings (256 rows, two a tick) 40 rows before a wrap; the whole state every
# GRAPH_DUPLEX_CHECK_EVERY ticks and at the end.
GRAPH_DUPLEX_TICKS = {"graph-duplex": 48, "graph-duplex-kv4": 24, "moshi-duplex": 24}
GRAPH_DUPLEX_CHECK_EVERY = 40
DUPLEX_TEXT_ONLY = (3, 7)  # slots of the traffic with an ASR delay of 6


def _duplex_graph_times(engine, tag, what, card, rope_per_tick=None):
    """The engine's tick with every slot open and fed a frame (``tick()``:
    the gather, the dispatch and, ``pipeline_depth`` - 1 ticks later, the
    fetch and post-processing): host ms a tick between returns (median, min,
    max over TICKS_TIMED after TICKS_WARM) and the observer's completion-to-completion
    interval; then, at depth 1, the device's busy share, kernel ms and device
    launches a tick from a profile (1 eager tick, 2 replays:
    ``rope_per_tick`` given for a replay, whose launches no wrapper counts);
    peak memory (reserved, a captured graph's pool included, and allocated)
    since the caller reset it."""
    import torch

    b, frame = engine.batch_size, engine.mimi_cfg.frame_size
    depth = engine.pipeline_depth
    opened = [engine.open_session(lambda ev: None) for _ in range(b - engine.used_slots())]
    check(engine.used_slots() == b, f"{tag}: slots left free for the timing")
    for drv in engine.slots:
        drv.push_pcm(_pcm(5, 0.08 * (TICKS_WARM + TICKS_TIMED), frame))
    dts = []
    engine.tick_observer = lambda dt, n, phases: dts.append(dt * 1e3)
    times = []
    with torch.inference_mode():
        for i in range(TICKS_WARM + TICKS_TIMED):
            t0 = time.perf_counter()
            check(engine.tick(), f"{tag}: a tick with {b} slots stepped nothing")
            if i >= TICKS_WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        while engine._inflight:  # the tick still in flight at depth 2
            engine._post_process(engine._inflight.popleft())
        engine.tick_observer = None
        n = 1 if rope_per_tick is None else 2
        engine.pipeline_depth = 1  # the profile: one tick, its fetch included
        for drv in engine.slots:
            drv.push_pcm(_pcm(6, 0.08 * n, frame))
        rows, wall_us = _profile(engine.tick, n, rope_launches=None if rope_per_tick is None
                                 else n * rope_per_tick)
        engine.pipeline_depth = depth
    kernel_ms = _print_profile(f"{tag}-profile", what, rows, wall_us, n, "tick", card, 6)
    for drv in opened:
        engine.close_session(drv)
    launches = sum(c for _, _, c in rows) / n
    peak = torch.cuda.max_memory_reserved() / 1e9
    peak_alloc = torch.cuda.max_memory_allocated() / 1e9
    tick_ms, dt_ms = statistics.median(times), statistics.median(dts[TICKS_WARM:])
    busy = kernel_ms / (wall_us / n / 1e3)
    print(f"[{tag}] {what}engine tick at pipeline_depth {depth}, {b} slots active: median "
          f"{tick_ms!r} ms, min {min(times)!r}, max {max(times)!r} over {TICKS_TIMED} after "
          f"{TICKS_WARM} warm-up; "
          f"completion-to-completion median {dt_ms!r} ms; at depth 1 (profiled): device busy "
          f"{busy!r}, {launches:.0f} device launches a tick, kernels {kernel_ms!r} ms a tick; "
          f"peak memory {peak:.2f} GB reserved ({peak_alloc:.2f} GB allocated); card {card}",
          flush=True)
    return {"step_ms": tick_ms, "min_ms": min(times), "max_ms": max(times), "dt_ms": dt_ms,
            "busy": busy, "launches": launches, "kernel_ms": kernel_ms, "peak_gb": peak,
            "peak_alloc_gb": peak_alloc}


def _duplex_against_eager(engine, tag, dev, seed):
    """From a state whose LM ring sits half of GRAPH_DUPLEX_TICKS rows and
    the codec rings 40 rows before a wrap (the LM rings full of real
    quantised rows), the eager tick (a shallow
    copy of the engine on clones of its key and states, params shared)
    beside the replay over GRAPH_DUPLEX_TICKS ticks of traffic: slots opened,
    closed and reset, partial masks, two text-only slots.  Every packed array
    bit for bit, and the key and every state every GRAPH_DUPLEX_CHECK_EVERY
    ticks and at the end."""
    import copy

    import numpy as np
    import torch

    b, frame = engine.batch_size, engine.mimi_cfg.frame_size
    lm_t = engine.state["lm"]["t"]
    codec = (engine.enc_state["enc_t"], engine.dec_state["dec_t"])
    lm_ring, codec_ring = lm_t["valid"].shape[1], codec[0]["valid"].shape[1]
    ticks = GRAPH_DUPLEX_TICKS[tag]
    _fill_rings(lm_t, torch.Generator(device=dev).manual_seed(seed), 3 * lm_ring - ticks // 2)
    with torch.inference_mode():
        for t in codec:
            t["pos"].fill_(3 * codec_ring - 40)
    ref = copy.copy(engine)
    ref.cuda_graph = False
    ref.rng = engine.rng.clone()
    ref.state, ref.enc_state, ref.dec_state = (
        _clone(engine.state), _clone(engine.enc_state), _clone(engine.dec_state))
    delay = np.zeros(b, np.int32)
    delay[list(DUPLEX_TEXT_ONLY)] = 6
    resets = partial = decoded = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i, (pcm, mask, reset) in enumerate(_graph_traffic(b, frame, ticks, seed)):
            resets += int(reset.sum())
            partial += int(0 < mask.sum() < b)
            got = engine._invoke_step(pcm, mask, reset, delay)
            want = ref._invoke_step(pcm, mask, reset, delay)
            check(np.array_equal(got, want),
                  f"{tag}: tick {i}: the replay's packed array differs from the eager tick's")
            decoded += int(got[2 * b:3 * b].sum())
            if (i + 1) % GRAPH_DUPLEX_CHECK_EVERY == 0 or i + 1 == ticks:
                diff = (_tree_diff(engine.state, ref.state)
                        + _tree_diff(engine.enc_state, ref.enc_state, "/enc")
                        + _tree_diff(engine.dec_state, ref.dec_state, "/dec")
                        + _tree_diff(engine.rng, ref.rng, "/rng"))
                check(not diff, f"{tag}: tick {i}: the state differs at {diff[:5]}")
    lm_pos, codec_pos = int(ref.state["lm"]["t"]["pos"]), int(ref.enc_state["enc_t"]["pos"])
    check(lm_pos > 3 * lm_ring and codec_pos > 3 * codec_ring and
          int(ref.dec_state["dec_t"]["pos"]) > 3 * codec_ring, f"{tag}: the rings did not wrap")
    check(decoded > 0, f"{tag}: no frame was decoded")
    ring = lm_t["layers"][0]["k"]
    print(f"[{tag}] {ticks} ticks of {engine.cfg.lm.transformer.num_layers} layers over "
          f"{ring.dtype} rings {tuple(ring.shape)} from one state, replay against the eager "
          f"tick (Mimi encode, lm_gen.step with the DepFormer, codec resets, Mimi decode): the "
          f"packed array (text tokens, steps, decode mask, pcm bits) bit for bit at every tick, "
          f"the key and the whole state (LM rings, scale rings, valid, pos, token buffers, "
          f"counters, Mimi rings and carries) every {GRAPH_DUPLEX_CHECK_EVERY} ticks and at the "
          f"end; {resets} slot resets, {partial} partial masks, text-only slots "
          f"{list(DUPLEX_TEXT_ONLY)}; {decoded} frames decoded; LM ring of {lm_ring} rows at "
          f"tick {lm_pos}, Mimi rings of {codec_ring} at {codec_pos}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del ref


def phase_graph_duplex(dev, card, eager_log):
    """The duplex tick as one captured CUDA graph, with dispatch-ahead: the
    engine as ``build_duplex`` makes it from configs/config-duplex-tpu-serving.toml
    as shipped (``pipeline_depth = 2``, ``cuda_graph`` left at its default,
    on), its tick captured by ``warmup()``.  (1) It serves ``[duplex]``'s
    workload from the same weights and session starts: each dialogue's events
    (text, every frame bit for bit) and the ticks equal to the eager depth-1
    engine's ``eager_log``; the kernels counted over its warm-up and capture
    (3 x per tick), none over the replays.  (2) Its tick timed at depth 2 and
    at depth 1.  (3) The replay held to the eager tick over
    GRAPH_DUPLEX_TICKS ticks past a wrap of every ring."""
    import torch

    from dsm_tpu_torch.server import builder

    tag = "graph-duplex"
    counters = _duplex_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mod = _duplex_module(tag, 8, 2)
    metrics0 = _metric_values()
    t0 = time.perf_counter()
    engine = builder.build_duplex(mod, dev)
    _check_duplex_engine(engine, 8)
    check(engine.cuda_graph and engine._graph is None and engine.pipeline_depth == 2,
          f"{tag}: the tick is not captured by default on CUDA, or not at depth 2")
    engine.warmup()  # two ticks on the side stream, then the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    check(engine._graph is not None, f"{tag}: no graph captured")

    ticks0 = engine.step_count
    t0 = time.perf_counter()
    sessions, idle, n_audio, n_text = _duplex_serve(engine, 12, 4, 2.0)
    serve_s = time.perf_counter() - t0
    log = _duplex_log(sessions, engine.step_count - ticks0)
    while engine._inflight:  # a reset-only tick may still be in flight at depth 2
        engine._post_process(engine._inflight.popleft())
    _check_metrics(tag, metrics0, {"lm_steps_total": engine.step_count - ticks0,
                                   "mimi_frames_decoded_total": n_audio,
                                   "warmup_success_total": 1}, dev, card)
    launches = {name: fn.launches for name, fn in counters.items()}
    check(log == eager_log, f"{tag}: the captured engine's events differ from the eager "
          f"engine's: first at {_first_difference(log, eager_log)}")
    want = {name: 3 * n for name, n in PER_TICK_DUPLEX.items()}
    check(launches == want, f"{tag}: launches {launches}, want {want} (warm-up + capture)")
    for sid in range(4, 16):
        engine.close_session(sessions[sid]["drv"])
    for drv in idle:
        engine.close_session(drv)
    print(f"[{tag}] built and captured in {capture_s:.2f} s; served [duplex]'s 16 dialogues "
          f"at pipeline_depth 2 in {log[1]} ticks ({serve_s:.3f} s): {n_audio} audio frames and "
          f"{n_text} text events, each dialogue's events (text, every frame bit for bit, Done "
          f"last) equal to the eager depth-1 engine's; kernel launches counted over its warm-up "
          f"and capture {launches} = 3 x per tick, none on replay", flush=True)

    rope = PER_TICK_DUPLEX["rope_qk"] + PER_TICK_DUPLEX["rope_commit"]
    numbers = {"launches": launches,
               "graph2": _duplex_graph_times(engine, tag, "captured: ", card, rope)}
    engine.pipeline_depth = 1
    numbers["graph"] = _duplex_graph_times(engine, tag, "captured: ", card, rope)
    engine.pipeline_depth = 2
    _duplex_against_eager(engine, tag, dev, seed=45)
    numbers["bench"] = phase_bench_duplex(engine, card)
    del engine
    torch.cuda.empty_cache()
    return numbers


def phase_graph_duplex_kv4(dev):
    """The captured duplex tick over packed-int4 rings (the serving TOML with
    ``kv_bits = 4``, uint8 (24,20,3072,64)): the replay held to the eager tick
    over GRAPH_DUPLEX_TICKS["graph-duplex-kv4"] ticks past a wrap of every
    ring, bit for bit."""
    import torch

    from dsm_tpu_torch.server import builder

    tag = "graph-duplex-kv4"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = builder.build_duplex(_duplex_module(tag, 4, 2), dev)
    _check_duplex_engine(engine, 4)
    engine.warmup()
    torch.cuda.synchronize()
    check(engine._graph is not None, f"{tag}: no graph captured")
    print(f"[{tag}] built and captured in {time.perf_counter() - t0:.2f} s", flush=True)
    _duplex_against_eager(engine, tag, dev, seed=47)
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The serving presets as shipped: configs/config-stt-tpu-serving.toml and
# configs/config-tts-tpu-serving.toml, each with its dispatch-ahead, its int16
# wire and (TTS) its fused frames, on the captured graphs.
# ---------------------------------------------------------------------------

STT_SERVING_FRAMES = 810  # a slot's frames: past the LM ring's 768 rows and the codec's 128
TTS_SERVING_REUSE_AT = 96  # the frame at which a finished session's slot is reopened
TTS_LONG_TEXT = " ".join(["one two three four five six seven eight nine ten"] * 5)  # 50 words
TTS_SCRIPT_OPS = 52  # init, 50 words, end of input: one session's queue


def _serving_module(name, tag):
    from dsm_tpu_torch.server import config as CFG

    path = os.path.join(ROOT, "configs", f"config-{name}-tpu-serving.toml")
    mod = CFG.Config.load(path).modules["asr" if name == "stt" else "tts"]
    keys = ("batch_size", "pipeline_depth", "pcm_wire", "fuse_ticks", "ca_int8")
    print(f"[{tag}] {os.path.relpath(path, ROOT)} as shipped: "
          f"{ {k: mod.raw[k] for k in keys if k in mod.raw} }, every key as in the file",
          flush=True)
    return mod


def _stt_serving_run(engine, pcm, tag):
    """Every slot opened with its stream, fed a frame at a time as clients
    send it (two frames ahead of the tick), then its marker and the delay's
    silence; the tick driven from this thread with the engine's post-process
    thread running, as ``start()`` runs them -> (events of each slot, host ms
    of each tick, post-process completion times, steps, the channels' ids)."""
    import threading

    import numpy as np

    frame, delay = engine.frame_size, engine.cfg.asr_delay_in_tokens
    chans, fed = [], [0] * engine.batch_size

    def feed():
        for slot, (ch, _) in enumerate(chans):
            n = len(pcm[slot])
            while fed[slot] < n and ch.buffered_samples() < 2 * frame:
                ch.push_pcm(pcm[slot][fed[slot]:fed[slot] + frame])
                fed[slot] += frame
                if fed[slot] >= n:  # the stream's end: its marker, then silence
                    engine.add_marker(ch, 1000 + slot)
                    ch.push_pcm(np.zeros(frame * (delay + 1), np.float32))

    for slot in range(engine.batch_size):
        events = []
        chans.append((engine.open_channel(events.append, seed=slot), events))
    check(engine.used_slots() == engine.batch_size, f"{tag}: slots left free")
    feed()
    done = []
    post = engine._process_item

    def timed(item):
        post(item)
        done.append(time.perf_counter())

    engine._process_item = timed
    engine.running = True
    engine._drain_thread = threading.Thread(target=engine._drain_loop, daemon=True)
    engine._drain_thread.start()
    ticks, steps0 = [], engine.step_count
    deadline = time.monotonic() + 300.0
    while any(ch.buffered_samples() >= frame for ch, _ in chans):
        check(time.monotonic() < deadline, f"{tag}: the streams did not drain")
        t0 = time.perf_counter()
        check(engine.tick(), f"{tag}: a tick stepped nothing")
        ticks.append((time.perf_counter() - t0) * 1e3)
        feed()
    check(fed == [len(x) for x in pcm], f"{tag}: a stream was not fed to its end")
    engine.flush()
    engine.stop()
    del engine._process_item
    log = [[(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                           getattr(w, "start_time", None), getattr(w, "stop_time", None))
                          for w in e.words], list(e.markers), e.prs.tobytes())
            for e in events] for _, events in chans]
    for ch, _ in chans:
        engine.close_channel(ch)
    return log, ticks, done, engine.step_count - steps0, [ch.channel_id for ch, _ in chans]


def _stt_serving_gc(cfg, params, b, pcm, log2, ticks2, tag, card):
    """The host GC's share of the tick's tail: the run above had the heap
    frozen after the engine's warm-up (``gc_tune``, as the builder ships
    it); the same run again on an engine built with ``gc_tune=False`` after
    ``gc.unfreeze()`` and CPython's default thresholds (700, 10, 10), events
    equal.  The max tick and the ticks over the 80 ms frame of each, after
    the first 10, and the gen2 collections during the run."""
    import gc

    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.utils.gc_tune import freeze_after_warmup

    gc.unfreeze()
    gc.set_threshold(700, 10, 10)
    engine = BatchedAsrEngine(cfg, params, batch_size=b, device="cuda", pipeline_depth=2,
                              pcm_wire_int16=True, gc_tune=False)
    check(engine.packer is not None, f"{tag}: the gc_tune=False engine has no native packer")
    engine.warmup()
    check(gc.get_freeze_count() == 0 and gc.get_threshold() == (700, 10, 10),
          f"{tag}: gc_tune=False touched the GC")
    gen2 = gc.get_stats()[2]["collections"]
    log0, ticks0, _, steps0, _ = _stt_serving_run(engine, pcm, tag)
    gen2 = gc.get_stats()[2]["collections"] - gen2
    check(log0 == log2, f"{tag}: without the GC freeze the events differ")
    del engine
    freeze_after_warmup()  # as the engines of the later phases leave it
    out = {}
    for what, ts in (("frozen", ticks2[10:]), ("not_frozen", ticks0[10:])):
        out[what] = {"max_ms": max(ts), "over_80": sum(t > 80.0 for t in ts), "ticks": len(ts),
                     "median_ms": statistics.median(ts)}
    f, n = out["frozen"], out["not_frozen"]
    print(f"[{tag}] the host GC, B={b} depth 2 as shipped: frozen after warm-up (gc_tune, the "
          f"default): tick max {f['max_ms']!r} ms, {f['over_80']} of {f['ticks']} over 80 ms, "
          f"median {f['median_ms']!r}; not frozen (gc_tune=False, thresholds 700/10/10): max "
          f"{n['max_ms']!r} ms, {n['over_80']} of {n['ticks']} over 80 ms, median "
          f"{n['median_ms']!r}, {gen2} gen2 collections in its run; events equal; card {card}",
          flush=True)
    out["gen2_not_frozen"] = gen2
    return out


def phase_stt_serving(dev, card):
    """``build_batched_asr`` from configs/config-stt-tpu-serving.toml as
    shipped: stt-1b at B=192 (``auto_batch_size`` does not clamp it), the step
    captured, two steps in flight (``pipeline_depth = 2``), the int16 upload
    wire, the native frame packer.  Every slot streams STT_SERVING_FRAMES
    frames and a marker (past the LM ring's and the codec ring's wraps); its
    events (steps, words, markers, VAD probabilities' bits) equal to those of
    the same engine at depth 1 on the deque mailboxes from the same weights,
    with a session logger on every channel whose text tokens read back rebuild
    the delivered words; the kernels counted over its warm-up and capture (3 x
    per step, none on replay); the metric registry's deltas equal to the run's
    steps, frames, warm-up and closed channels.  Then host ms a tick at depth 2
    and completion-to-completion, and from ``_graph_times`` host ms a
    synchronous step, device busy, launches and kernel ms a step and peak
    memory; the largest batch that ``auto_batch_size`` fits on the card."""
    import numpy as np
    import torch

    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import metrics as M
    from dsm_tpu_torch.server.autoconfig import auto_batch_size, device_memory_bytes
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.sessions.asr import WordState
    from dsm_tpu_torch.utils.session_log import SessionLogger, load_session

    tag = "graph-stt-serving"
    mod = _serving_module("stt", tag)
    counters = {name: _duplex_counters()[name] for name in PER_STEP}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics0 = _metric_values()
    logs = tempfile.TemporaryDirectory(prefix="chip-smoke-sessions-")
    t0 = time.perf_counter()
    engine = builder.build_batched_asr(mod, dev)
    check(engine.batch_size == 192 and engine.pipeline_depth == 2 and engine._pcm_wire_int16
          and engine.cuda_graph, f"{tag}: built B={engine.batch_size} depth "
          f"{engine.pipeline_depth} int16 {engine._pcm_wire_int16}, not the file's")
    check(engine.packer is not None, f"{tag}: the engine as shipped has no native packer")
    engine.warmup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b, frame = engine.batch_size, engine.frame_size
    pcm = [_pcm(slot % 16, STT_SERVING_FRAMES * frame / 24000.0, frame) *
           np.float32(0.5 + (slot % 5) / 2) for slot in range(b)]  # loud streams clip
    t0 = time.perf_counter()
    log2, ticks2, done2, steps2, _ = _stt_serving_run(engine, pcm, tag)
    serve_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    frames = sum(len(evs) for evs in log2)
    _check_metrics(tag, metrics0, {"lm_steps_total": steps2, "mimi_frames_encoded_total": frames,
                                   "warmup_success_total": 1,
                                   "asr_connection_num_steps_count": b}, dev, card)
    check(M.ASR_OPEN_CHANNELS.get() == 0, f"{tag}: open channels {M.ASR_OPEN_CHANNELS.get()}")
    want = {name: 3 * n for name, n in PER_STEP.items()}
    check(launches == want, f"{tag}: launches {launches}, want {want} (warm-up + capture)")
    peak = torch.cuda.max_memory_reserved() / 1e9
    peak_alloc = torch.cuda.max_memory_allocated() / 1e9
    lm_pos = int(engine.state["lm"]["t"]["pos"])
    codec_pos = int(engine.state["mimi_enc"]["enc_t"]["pos"])
    lm_ring = engine.state["lm"]["t"]["valid"].shape[1]
    codec_ring = engine.state["mimi_enc"]["enc_t"]["valid"].shape[1]
    check(steps2 >= 800 and lm_pos > lm_ring and codec_pos > codec_ring,
          f"{tag}: {steps2} steps, LM ring at {lm_pos} of {lm_ring}, codec at {codec_pos}")
    for slot, evs in enumerate(log2):
        check([e[0] for e in evs] == list(range(1, len(evs) + 1)) and len(evs) == steps2,
              f"{tag}: slot {slot}: {len(evs)} step events for {steps2} steps")
        check([m for e in evs for m in e[2]] == [1000 + slot], f"{tag}: slot {slot}: markers")
        prs = np.frombuffer(b"".join(e[3] for e in evs), np.float32)
        check(prs.size == 4 * steps2 and bool(np.isfinite(prs).all()),
              f"{tag}: slot {slot}: bad VAD probabilities")
    words = sum(len(e[1]) for evs in log2 for e in evs)
    dt2 = np.diff(np.asarray(done2)) * 1e3
    print(f"[{tag}] built and captured in {build_s:.2f} s: B={b} (auto_batch_size: no clamp), "
          f"pipeline_depth 2, int16 wire; {steps2} steps ({serve_s:.1f} s) with every slot "
          f"streaming, {words} word events, {b} markers; LM ring of {lm_ring} rows at tick "
          f"{lm_pos}, codec ring of {codec_ring} at {codec_pos}; kernel launches counted over "
          f"its warm-up and capture {launches} = 3 x per step, none on replay", flush=True)
    print(f"[{tag}] depth 2, {b} slots streaming: tick host ms median "
          f"{statistics.median(ticks2[10:])!r} (min {min(ticks2[10:])!r}, max "
          f"{max(ticks2[10:])!r}) over {len(ticks2) - 10} after 10, with the native packer and "
          f"the metric calls, the streams fed a frame at a time between ticks (before them: "
          f"the deque mailboxes, no metrics, every stream pushed before the first tick, "
          f"15.91-16.89 ms, PERF.md section 5); completion-to-completion "
          f"median {float(np.median(dt2[10:]))!r} ms (max {float(dt2[10:].max())!r}); peak memory "
          f"{peak:.2f} GB reserved ({peak_alloc:.2f} GB allocated); card {card}", flush=True)
    numbers = {"launches": launches, "tick_ms": statistics.median(ticks2[10:]),
               "dt_ms": float(np.median(dt2[10:])), "peak_gb": peak}
    params, cfg = engine.params, engine.cfg
    del engine
    torch.cuda.empty_cache()
    # The reference logs its sessions, written as each channel closes (10**6 steps a flush).
    ref = BatchedAsrEngine(cfg, params, batch_size=b, device=dev, pipeline_depth=1,
                           pcm_wire_int16=True, use_native_packer=False,
                           session_logger=SessionLogger(logs.name, flush_every_steps=10 ** 6))
    check(ref.packer is None, f"{tag}: the reference engine is not on the deque mailboxes")
    ref.warmup()
    log1, ticks1, done1, steps1, ids1 = _stt_serving_run(ref, pcm, tag)
    check(steps1 == steps2 and log1 == log2, f"{tag}: the depth-2 events differ from the "
          f"depth-1 engine's (steps {steps2} / {steps1})")
    for slot, sid in enumerate(ids1):
        text, audio, _ = load_session(os.path.join(logs.name, f"dsm-tpu-asr-{sid}.safetensors"))
        ws = WordState(cfg, 1)
        words = [e.tokens for step, tok in enumerate(text, start=1)
                 for e in ws.process([tok], [step], [True]) if hasattr(e, "tokens")]
        delivered = [w[1] for e in log1[slot] for w in e[1] if w[0] == "WordEvent"]
        check(words == delivered and text.shape == (len(log1[slot]),)
              and audio.shape == (len(log1[slot]), cfg.mimi.n_q),
              f"{tag}: slot {slot}: the session log's {text.shape[0]} text tokens do not "
              f"rebuild its {len(delivered)} delivered words")
    logs.cleanup()
    print(f"[{tag}] the depth-1 reference's session logs ({b} channels, {steps1} steps each) "
          f"read back: text tokens rebuild every delivered word, audio codes "
          f"({cfg.mimi.n_q} a step) logged", flush=True)
    dt1 = np.diff(np.asarray(done1)) * 1e3
    print(f"[{tag}] the same engine at depth 1 on the deque mailboxes with a session logger, "
          f"from the same weights: "
          f"{steps1} steps, every slot's events (steps, words, markers, VAD probabilities' "
          f"bits) equal to depth 2's on the native packer; "
          f"depth 1 tick host ms median {statistics.median(ticks1[10:])!r}, "
          f"completion-to-completion median {float(np.median(dt1[10:]))!r} ms; card {card}",
          flush=True)
    numbers["tick_ms_depth1"] = statistics.median(ticks1[10:])
    numbers["dt_ms_depth1"] = float(np.median(dt1[10:]))
    del ref
    torch.cuda.empty_cache()
    numbers["gc"] = _stt_serving_gc(cfg, params, b, pcm, log2, ticks2, tag, card)
    torch.cuda.reset_peak_memory_stats()
    engine = BatchedAsrEngine(cfg, params, batch_size=b, device=dev, pipeline_depth=2,
                              pcm_wire_int16=True)
    engine.warmup()
    numbers["step"] = _graph_times(engine, tag, "captured, int16 wire: ", card,
                                   PER_STEP["rope_qk"] + PER_STEP["rope_commit"])
    fit = auto_batch_size(10 ** 6, mod.lm, device_memory_bytes(dev))
    print(f"[{tag}] auto_batch_size: the largest batch that fits this card is {fit} (the file "
          f"asks 192); card {card}", flush=True)
    numbers["fit"] = fit
    numbers["bench"] = phase_bench_stt(engine, card)
    del engine, params
    torch.cuda.empty_cache()
    return numbers


def _tts_serving_run(engine, sessions_cfg, reuse_sid, tag):
    """The 64-slot workload on ``engine``: every slot opened before the first
    tick with its words fed and its input ended (slot 0's session 50 words),
    at frame TTS_SERVING_REUSE_AT session ``reuse_sid`` (finished by then)
    closed and session 64 opened in its slot -> (events of each session,
    frames dispatched, the frames the engine had dispatched (the current
    tick's included) when each session's first audio was delivered, host ms
    of each tick, post completion times)."""
    from dsm_tpu_torch.server.tts_batched import AudioEvent

    fuse = engine.fuse
    state = {"frames": 0}
    sessions, first_audio = {}, {}
    steps0 = engine.step_count

    def open_(sid, voice, text):
        events = []

        def deliver(ev, sid=sid, events=events):
            if isinstance(ev, AudioEvent) and sid not in first_audio:
                first_audio[sid] = engine.step_count - steps0
            events.append(ev)

        ca = engine.voice_kv(voice) if voice else None
        drv = engine.open_session(deliver, voice_ca=ca, seed=100 + sid, text_temperature=0.6,
                                  audio_temperature=0.8)
        check(drv is not None, f"{tag}: no free slot")
        enc, _ = engine.encode_words(text, inserted_bos=False)
        drv.feed_words(enc)
        drv.end_input()
        sessions[sid] = {"drv": drv, "events": events, "text": text}
        return drv

    for sid, (voice, text) in enumerate(sessions_cfg):
        open_(sid, voice, text)
    check(engine.used_slots() == engine.batch_size, f"{tag}: slots left free")
    done, ticks = [], []
    if fuse > 1:
        post = engine._post_fused

        def timed(item):
            post(item)
            done.append(time.perf_counter())  # one a dispatch posted

        engine._post_fused = timed
    deadline = time.monotonic() + 600.0
    while True:
        check(time.monotonic() < deadline, f"{tag}: sessions did not finish")
        if state["frames"] == TTS_SERVING_REUSE_AT:
            drv = sessions[reuse_sid]["drv"]
            check(drv.finished, f"{tag}: session {reuse_sid} still runs at frame "
                  f"{TTS_SERVING_REUSE_AT}")
            engine.close_session(drv)
            check(open_(64, "spk3", TTS_TEXTS[3]).slot == drv.slot,
                  f"{tag}: session 64 did not reuse slot {drv.slot}")
        t0 = time.perf_counter()
        if not engine.tick():
            break
        ticks.append((time.perf_counter() - t0) * 1e3)
        state["frames"] += fuse
        if fuse == 1:
            done.append(time.perf_counter())
    if fuse > 1:
        del engine._post_fused
    for s in sessions.values():
        engine.close_session(s["drv"])
    return sessions, state["frames"], first_audio, ticks, done


def _tts_serving_times(engine, tag, card, rope_per_frame):
    """Every slot with a 50-word session: host ms a tick at the engine's
    depth (a dispatch of ``fuse`` frames; from the second on the tick also
    posts the one before) over 12 after 3, completion-to-completion of the
    posts; then at depth 1 a profile of one dispatch (its fetch included):
    device busy, launches and kernel ms a dispatch."""
    import torch

    fuse, depth = engine.fuse, engine.pipeline_depth
    drvs = []
    for sid in range(engine.batch_size):
        drv = engine.open_session(lambda ev: None, seed=500 + sid)
        enc, _ = engine.encode_words(TTS_LONG_TEXT, inserted_bos=False)
        drv.feed_words(enc)
        drvs.append(drv)
    done, times = [], []
    post = engine._post_fused

    def timed(item):
        post(item)
        done.append(time.perf_counter())

    engine._post_fused = timed
    with torch.inference_mode():
        for i in range(15):
            t0 = time.perf_counter()
            check(engine.tick(), f"{tag}: a dispatch stepped nothing")
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        while engine._inflight_f:
            engine._post_fused(engine._inflight_f.popleft())
        del engine._post_fused
        engine.pipeline_depth = 1
        rows, wall_us = _profile(engine.tick, 1, rope_launches=fuse * rope_per_frame)
        engine.pipeline_depth = depth
    kernel_ms = _print_profile(f"{tag}-profile", "captured, one dispatch: ", rows, wall_us, 1,
                               "dispatch", card, 6)
    for drv in drvs:
        engine.close_session(drv)
    launches = sum(c for _, _, c in rows)
    tick_ms = statistics.median(times)
    dt_ms = statistics.median([(b - a) * 1e3 for a, b in zip(done[3:], done[4:])])
    busy = kernel_ms / (wall_us / 1e3)
    print(f"[{tag}] dispatch of {fuse} frames at pipeline_depth {depth}, "
          f"{engine.batch_size} slots active: tick host ms median {tick_ms!r} ({tick_ms / fuse!r} "
          f"a frame), min {min(times)!r}, max {max(times)!r} over 12 after 3; "
          f"completion-to-completion median {dt_ms!r} ms ({dt_ms / fuse!r} a frame); at depth "
          f"1 (profiled): device busy {busy!r}, {launches:.0f} device launches a dispatch, "
          f"kernels {kernel_ms!r} ms a dispatch; card {card}", flush=True)
    return {"tick_ms": tick_ms, "dt_ms": dt_ms, "busy": busy, "device_launches": launches,
            "kernel_ms": kernel_ms}


def _script_ops_ms(engine, tag, card):
    """One session's queue (TTS_SCRIPT_OPS ops: init, 50 one-chunk words,
    end of input) applied to the device machine as the engine applies it:
    host ms of the call and ms to its completion on the card (median of 20
    after 3), on a machine whose slot 0 is then re-initialised."""
    import numpy as np
    import torch

    from dsm_tpu_torch.sessions import tts_script as SCRIPT

    ops = [(SCRIPT.OP_INIT, 0, None, 0, 0, 0)]
    for wid in range(TTS_SCRIPT_OPS - 2):
        toks = np.zeros(SCRIPT.WORD_CHUNK, np.int32)
        toks[:3] = [11 + wid, 12 + wid, 13 + wid]
        ops.append((SCRIPT.OP_WORD, 0, toks, 3, wid, 3 * wid))
    ops.append((SCRIPT.OP_EOS, 0, None, 0, 0, 0))
    host, total = [], []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._apply_script_ops(ops)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i >= 3:
            host.append((t1 - t0) * 1e3)
            total.append((time.perf_counter() - t0) * 1e3)
    m = engine._mstate
    check(int(m["n_words"][0]) == TTS_SCRIPT_OPS - 2 and bool(m["eos"][0])
          and int(m["toks"][0, 3 * 49 + 2]) == 13 + 49, f"{tag}: the op table was not applied")
    print(f"[{tag}] apply_ops of a {len(ops)}-op queue (init, {TTS_SCRIPT_OPS - 2} words, end "
          f"of input; one staged copy of {engine._ops_in.buffers['ops'].shape[0]} rows): host "
          f"ms median {statistics.median(host)!r}, to completion on the card "
          f"{statistics.median(total)!r} (max {max(total)!r}) over 20; card {card}", flush=True)
    return statistics.median(total)


def phase_tts_serving(dev, card):
    """``build_batched_tts`` from configs/config-tts-tpu-serving.toml as
    shipped: tts-1.6b at B=64, ``fuse_ticks = 4`` (the device script
    machine; one frame captured, replayed 4 times a dispatch),
    ``pipeline_depth = 2``, ``ca_int8``, the int16 wire.  The 64-slot
    workload (one 50-word session, voices on 8 slots, a reused slot at frame
    TTS_SERVING_REUSE_AT) against the captured single-tick engine
    (``fuse_ticks = 1``, depth 1, otherwise the same file and weights): each
    session's events (words, times, audio words, Done) bit for bit; the
    kernels counted over the fused engine's warm-up and capture (3 x per
    frame, none on replay).  Then ms a dispatch and a frame,
    completion-to-completion, the delay to first audio in frames, launches a
    dispatch, the 52-op ``apply_ops`` and peak memory."""
    import torch

    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server.tts_batched import BatchedTtsEngine

    tag = "graph-tts-serving"
    mod = _serving_module("tts", tag)
    counters = _tts_counters(PER_TICK_TTS)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = builder.build_batched_tts(mod, dev)
    check(engine.batch_size == 64 and engine.fuse == 4 and engine.pipeline_depth == 2
          and engine.ca_quant and engine._pcm_wire_i16 and engine.cuda_graph
          and engine.script_cap == 1024, f"{tag}: not the file's engine")
    _tts_voices(engine)
    metrics0 = _metric_values()
    engine.warmup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan = [(None, TTS_LONG_TEXT)] + [(f"spk{sid}" if sid < 8 else None,
                                       TTS_TEXTS[sid % len(TTS_TEXTS)]) for sid in range(1, 64)]
    reuse = 10  # "short one": finished well before the reuse frame
    t0 = time.perf_counter()
    fused, frames_f, first_f, ticks_f, posted = _tts_serving_run(engine, plan, reuse, tag)
    serve_s = time.perf_counter() - t0
    frame = engine.mimi_cfg.frame_size
    n_audio = _tts_verify(fused, range(65), frame)
    _check_metrics(tag, metrics0, {"lm_steps_total": 4 * len(posted),
                                   "lm_step_duration_seconds_count": len(posted),
                                   "mimi_frames_decoded_total": n_audio,
                                   "warmup_success_total": 1}, dev, card)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 3 * n for name, n in PER_TICK_TTS.items()}
    check(launches == want, f"{tag}: launches {launches}, want {want} (warm-up + capture)")
    check(len(fused[0]["text"].split()) >= 50 and frames_f >= 160,
          f"{tag}: {frames_f} frames, a {len(fused[0]['text'].split())}-word session")
    print(f"[{tag}] built and captured in {build_s:.2f} s: B=64, fuse_ticks 4, pipeline_depth "
          f"2, int8 voice store, int16 wire, script ring {engine.script_cap}; served 65 "
          f"sessions (a 50-word one, 8 voices, session 64 in slot "
          f"{fused[64]['drv'].slot} reused at frame {TTS_SERVING_REUSE_AT}) in {frames_f} "
          f"frames ({serve_s:.1f} s): {n_audio} audio frames, every word back, Done last; "
          f"kernel launches counted over its warm-up and capture {launches} = 3 x per frame, "
          f"none on replay", flush=True)
    rope = PER_TICK_TTS["rope_qk"] + PER_TICK_TTS["rope_commit"]
    numbers = {"launches": launches, **_tts_serving_times(engine, tag, card, rope)}
    numbers["ops_ms"] = _script_ops_ms(engine, tag, card)
    peak = torch.cuda.max_memory_reserved() / 1e9
    peak_alloc = torch.cuda.max_memory_allocated() / 1e9
    numbers["peak_gb"] = peak
    print(f"[{tag}] peak memory of the fused engine {peak:.2f} GB reserved ({peak_alloc:.2f} "
          f"GB allocated); card {card}", flush=True)
    _offline_synthesize_jsonl(engine, card)
    numbers["bench"] = phase_bench_tts(engine, card)
    ref = BatchedTtsEngine(
        engine.cfg, engine.params, engine.mimi_cfg, engine.mimi_params, engine.tokenizer,
        batch_size=64, ca_len=engine.ca_len, cfg_enabled=engine.cfg_enabled,
        ca_quant=engine.ca_quant, device=dev, pcm_wire_int16=True, fuse_ticks=1,
        pipeline_depth=1)
    ref.voices = engine.voices
    del engine
    torch.cuda.empty_cache()
    ref.warmup()
    single, frames_s, first_s, ticks_s, _ = _tts_serving_run(ref, plan, reuse, tag)
    log_f, log_s = _tts_log(fused, frames_f)[0], _tts_log(single, frames_s)[0]
    check(log_f == log_s, f"{tag}: the fused engine's events differ from the single-tick "
          f"engine's: first at {_first_difference((log_f, 0), (log_s, 0))}")
    check(first_f[0] >= first_s[0], f"{tag}: first audio delivered earlier fused than single")
    numbers["first_audio"] = (first_s[0], first_f[0])
    print(f"[{tag}] the captured single-tick engine (fuse_ticks 1, depth 1, the same file and "
          f"weights): {frames_s} frames; every session's events (words, times, audio words, "
          f"Done) equal to the fused engine's; session 0's first audio delivered when "
          f"{first_s[0]} frames were dispatched single-tick, {first_f[0]} fused at depth 2 "
          f"(+{first_f[0] - first_s[0]} frames); single-tick host ms a frame median "
          f"{statistics.median(ticks_s[10:])!r}; card {card}", flush=True)
    del ref
    torch.cuda.empty_cache()
    return numbers


# ---------------------------------------------------------------------------
# The benchmarks of bench_perf.py on the serving engines
# ---------------------------------------------------------------------------


def _frames_checked(engine, audio_cls):
    """``engine.open_session`` wrapped so that every delivered audio frame is
    counted a session and checked (1,920 finite samples) -> (the counts of
    each session in opening order, the bad frames, the unwrap)."""
    import numpy as np

    per_session, bad = [], []
    open_ = engine.open_session

    def open_session(deliver, *args, **kwargs):
        i = len(per_session)
        per_session.append(0)

        def checked(ev):
            if isinstance(ev, audio_cls):
                per_session[i] += 1
                pcm = np.asarray(ev.pcm)
                if pcm.shape != (1920,) or not bool(np.isfinite(pcm).all()):
                    bad.append((i, pcm.shape))
            deliver(ev)

        return open_(checked, *args, **kwargs)

    engine.open_session = open_session
    return per_session, bad, lambda: delattr(engine, "open_session")


def _free_slots(engine, tag, close):
    """Close what an earlier run left open on ``engine``: the bench opens
    all its slots afresh."""
    for item in list(engine.slots):
        if item is not None:
            close(item)
    check(engine.used_slots() == 0, f"{tag}: slots still taken")


def _print_bench(tag, res, card, what, t_phase=None):
    print(f"[{tag}] {json.dumps(res)}", flush=True)
    took = "" if t_phase is None else f"; {time.perf_counter() - t_phase:.1f} s in all"
    print(f"[{tag}] {what}{took}; card {card}", flush=True)


def phase_bench_duplex(engine, card):
    """``[bench-duplex]``: ``bench_perf.bench_duplex_sustained`` on
    ``[graph-duplex]``'s engine (s2s-2b, B=24, depth 2, captured), BENCH_S
    seconds of zero pcm at the 80 ms cadence: every dialogue hears audio,
    every frame 1,920 finite samples, the engine ticked."""
    from dsm_tpu_torch import bench_perf as BP
    from dsm_tpu_torch.server.duplex_batched import DuplexAudioEvent

    tag = "bench-duplex"
    t_phase = time.perf_counter()
    _free_slots(engine, tag, engine.close_session)
    frames, bad, unwrap = _frames_checked(engine, DuplexAudioEvent)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bench-") as tmp:
        path = os.path.join(tmp, "events.json")
        res = BP.bench_duplex_sustained(engine.batch_size, BENCH_S, events_path=path,
                                        drain_s=BENCH_DRAIN_S, engine=engine)
        with open(path) as f:
            ticks = json.load(f)["ticks"]
    unwrap()
    b = engine.batch_size
    check(len(frames) == b and min(frames) > 0, f"{tag}: dialogues without audio: {frames}")
    check(not bad, f"{tag}: bad frames {bad[:5]}")
    check(len(ticks) > 0 and res["n_events"] > 0 and engine.used_slots() == 0,
          f"{tag}: {len(ticks)} ticks, {res['n_events']} events")
    _print_bench(tag, res, card, f"s2s-2b B={b} depth {engine.pipeline_depth}, captured: "
                 f"{len(ticks)} ticks, {sum(frames)} audio frames (each 1,920 finite samples; "
                 f"{min(frames)}-{max(frames)} a dialogue of {res['frames_sent_per_session']} "
                 f"sent); tick max {max(t['step_ms'] for t in ticks)!r} ms; realtime_ok "
                 f"{res['realtime_ok']} (measured, not checked)", t_phase)
    return res


def phase_bench_tts(engine, card):
    """``[bench-tts]``: ``bench_perf.bench_tts_sustained`` on
    ``[graph-tts-serving]``'s fused engine (tts-1.6b, B=64, fuse 4, depth 2,
    int8 voices, int16 wire, captured): one cohort of B sessions of
    BENCH_TTS_WORDS words: every session ends (Done), every frame 1,920
    finite samples."""
    from dsm_tpu_torch import bench_perf as BP
    from dsm_tpu_torch.server.tts_batched import AudioEvent

    tag = "bench-tts"
    t_phase = time.perf_counter()
    _free_slots(engine, tag, engine.close_session)
    frames, bad, unwrap = _frames_checked(engine, AudioEvent)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bench-") as tmp:
        path = os.path.join(tmp, "events.json")
        res = BP.bench_tts_sustained(engine.batch_size, BENCH_TTS_S, engine=engine,
                                     n_words=BENCH_TTS_WORDS, drain_s=BENCH_DRAIN_S,
                                     events_out=path)
        with open(path) as f:
            rows = json.load(f)
    unwrap()
    b = engine.batch_size
    check(res.get("sessions_completed") == res.get("sessions_launched") == b,
          f"{tag}: {res.get('sessions_completed')} of {res.get('sessions_launched')} sessions "
          f"ended, B={b}")
    check(len(frames) == b and min(frames) > 0 and not bad,
          f"{tag}: frames a session {frames}, bad {bad[:5]}")
    check(len(rows) > 0 and all(len(r) == 11 for r in rows) and engine.used_slots() == 0,
          f"{tag}: {len(rows)} tick rows, not each with the fused path's 10 fields and t")
    _print_bench(tag, res, card, f"tts-1.6b B={b} fuse {engine.fuse} depth "
                 f"{engine.pipeline_depth}, captured: {len(rows)} dispatches, {sum(frames)} "
                 f"audio frames (each 1,920 finite samples), every session's Done; dispatch max "
                 f"{max(sum(r[k] for k in ('gather_ms', 'dispatch_ms', 'fetch_ms', 'post_ms')) for r in rows)!r} "
                 f"ms; realtime_sessions_frac {res['realtime_sessions_frac']} (measured)",
                 t_phase)
    return res


def phase_bench_stt(engine, card):
    """``[bench-stt]``: ``bench_perf.bench_server_sustained`` on
    ``[graph-stt-serving]``'s engine (stt-1b, B=192, depth 2, int16 wire,
    captured, native packer), BENCH_S seconds at the 80 ms cadence, then
    each channel's marker: every marker delivered, ``throughput_ok``, the
    engine stepped, its events rows one a step in time order with the JAX
    keys; ``slo_ok`` and ``realtime_ok`` printed.  Then ``[bench-memory]``."""
    from dsm_tpu_torch import bench_perf as BP

    tag = "bench-stt"
    t_phase = time.perf_counter()
    _free_slots(engine, tag, engine.close_channel)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bench-") as tmp:
        path = os.path.join(tmp, "events.json")
        res = BP.bench_server_sustained(engine.batch_size, BENCH_S, events_out=path,
                                        engine=engine)
        with open(path) as f:
            rows = json.load(f)
    b = engine.batch_size
    check(res["markers_completed"] == b, f"{tag}: {res['markers_completed']} of {b} markers")
    check(res["throughput_ok"], f"{tag}: a slot stepped {res['slot_steps_min']} times, "
          f"{res['expected_steps_realtime']} realtime")
    check(res["engine_steps"] > 0 and len(rows) == res["engine_steps"]
          and all(a["t"] <= c["t"] for a, c in zip(rows, rows[1:]))
          and all({"t", "step_ms", "util", "queue_ms", "fetch_ms", "post_ms"} <= set(r)
                  for r in rows), f"{tag}: events rows")
    check(engine.used_slots() == 0, f"{tag}: channels left open")
    d = res["delivery"]
    _print_bench(tag, res, card, f"stt-1b B={b} depth {engine.pipeline_depth}, int16 wire, "
                 f"captured: step p50 / p95 / p99 {res['step_ms_p50']!r} / "
                 f"{res['step_ms_p95']!r} / {res['step_ms_p99']!r} ms, max "
                 f"{max(r['step_ms'] for r in rows)!r}; delivery lag p99 {d['lag_ms_p99']!r} "
                 f"ms; throughput_ok {res['throughput_ok']}, slo_ok {res['slo_ok']}, "
                 f"realtime_ok {res['realtime_ok']} (the last two measured, not checked)",
                 t_phase)
    mem = BP.bench_memory(engine.device)
    check(0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"],
          f"[bench-memory] {mem}")
    _print_bench("bench-memory", mem, card, f"with [bench-stt]'s engine alive: "
                 f"{mem['bytes_in_use'] / 1e9:.2f} GB in use, peak "
                 f"{mem['peak_bytes_in_use'] / 1e9:.2f} GB, of {mem['bytes_limit'] / 1e9:.2f}")
    return res


# ---------------------------------------------------------------------------
# Checkpoints in the reference layout, and the single-session TTS
# ---------------------------------------------------------------------------

CKPT_MODELS = (("stt", "asr"), ("tts", "tts"))  # config-<name>.toml and its module


def _params_same(a, b) -> bool:
    """Two param trees bit for bit (a weight's profile, ``w8a8``, equal)."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_params_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_params_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return _bits_equal(a, b)
    return a == b


def _file_size_gb(*paths) -> float:
    return sum(os.path.getsize(p) for p in paths) / 1e9


def _tts_sessions(engine, texts, voice, seed0):
    """``synthesize`` of each text (the voice ``voice`` for those marked
    True), host ms of every tick -> ``([(pcm, words)], tick ms)``."""
    tick = engine.tick
    times = []

    def timed(mode, tok):
        t0 = time.perf_counter()
        out = tick(mode, tok)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.tick = timed
    try:
        out = []
        for i, (text, with_voice) in enumerate(texts):
            kv = engine.voice_kv(voice) if with_voice else None
            pcm, words = engine.synthesize(text, ca_kv=kv, seed=seed0 + i)
            out.append((pcm, [(w.text, w.start_s, w.stop_s) for w in words]))
    finally:
        del engine.tick
    return out, times


def _check_tts_sessions(tag, texts, results, frame):
    import numpy as np

    n = 0
    for (text, _), (pcm, words) in zip(texts, results):
        check([w[0] for w in words] == text.split(), f"{tag}: words {words} for {text!r}")
        check(pcm.size > 0 and pcm.size % frame == 0 and bool(np.isfinite(pcm).all()),
              f"{tag}: {pcm.size} samples, not whole finite frames of {frame}")
        n += pcm.size // frame
    return n


def phase_ckpt(dev, card, tmp):
    """configs/config-stt.toml (stt-1b) and configs/config-tts.toml
    (tts-1.6b) at full width: the builder's own seeded tree of each (the
    random init a TOML whose files are absent gets) written to
    reference-layout bf16 safetensors by the port's writer.  configs/
    config-stt.toml is then built through ``cli.build_engines`` twice, with
    its ``lm_model_file`` and ``audio_tokenizer_file`` pointed at the files
    and as shipped (the same tree, in memory): every parameter bit for bit,
    and the events of 4 streams with markers through the captured step bit
    for bit.  configs/config-tts.toml's engines are built and held to each
    other in ``[tts-single]`` -> ``{name: (lm file, mimi file)}``."""
    import torch

    from dsm_tpu_torch import cli
    from dsm_tpu_torch.models import mimi as MIMI
    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import config as CFG
    from dsm_tpu_torch.utils import checkpoint as CK

    files = {}
    dtype = torch.bfloat16 if torch.device(dev).type == "cuda" else torch.float32  # the builder's
    for name, kind in CKPT_MODELS:
        path = os.path.join(ROOT, "configs", f"config-{name}.toml")
        mod = CFG.Config.load(path).modules[kind]
        gen = torch.Generator(device=dev)
        lm, loaded = builder._load_or_init_lm(mod, gen, dtype)
        mimi_cfg = MIMI.v0_1(mod.lm.audio_codebooks if kind == "asr"
                             else mod.lm.generated_codebooks)
        mimi, _ = builder._load_or_init_mimi(mod, mimi_cfg, gen, dtype)
        check(not loaded, f"ckpt: {mod.lm_model_file} is on this machine")
        files[name] = (os.path.join(tmp, f"{name}-lm.safetensors"),
                       os.path.join(tmp, f"{name}-mimi.safetensors"))
        t0 = time.perf_counter()
        ref = CK.lm_params_to_reference(mod.lm, lm)
        n_params = sum(t.numel() for t in ref.values())
        CK.save_safetensors(files[name][0], ref, dtype)
        CK.save_safetensors(files[name][1], CK.mimi_params_to_reference(mimi_cfg, mimi), dtype)
        print(f"[ckpt] {os.path.relpath(path, ROOT)}: the builder's seeded tree ({n_params} LM "
              f"parameters) written as reference-layout bf16 safetensors "
              f"({_file_size_gb(*files[name]):.2f} GB, LM + Mimi) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del ref, lm, mimi
        torch.cuda.empty_cache()
    path = os.path.join(ROOT, "configs", "config-stt.toml")
    local = CFG.Config.load(path)
    local.modules["asr"].lm_model_file, local.modules["asr"].audio_tokenizer_file = files["stt"]
    t0 = time.perf_counter()
    eng_file = cli.build_engines(local, dev)["asr"]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng_mem = cli.build_engines(CFG.Config.load(path), dev)["asr"]
    check(_params_same(eng_file.params, eng_mem.params),
          "ckpt stt: the engine's parameters from the files differ from memory's")
    logs = []
    for eng in (eng_file, eng_mem):
        eng.warmup()
        eng._fill_gate_frac = 0.0  # fill gate off, so that both step the same frames
        sessions = {}
        for sid in range(4):
            _open(eng, sid, 2.0 + sid / 4.0, sessions, seed=sid)
        _drive(eng, sessions)
        _verify(sessions, range(4), eng.cfg.lm.extra_heads[0])
        logs.append({sid: [(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                                          getattr(w, "start_time", None)) for w in e.words],
                            list(e.markers), e.prs.tobytes()) for e in s["events"]]
                     for sid, s in sessions.items()})
        for s in sessions.values():
            eng.close_channel(s["ch"])
    check(logs[0] == logs[1], "ckpt stt: the events of the engine from the files differ "
          "from those of the engine from memory")
    print(f"[ckpt] configs/config-stt.toml through cli.build_engines from the files: loaded "
          f"and built in {load_s:.2f} s ({_file_size_gb(*files['stt']):.2f} GB; the reads warm: "
          f"the files were just written); every parameter and the events of 4 streams "
          f"({sum(len(v) for v in logs[0].values())} step events, VAD probabilities' bits) "
          f"bit for bit those of the engine built as shipped (the same seeded tree in memory); "
          f"card {card}", flush=True)
    del eng_file, eng_mem
    torch.cuda.empty_cache()
    return files


def _single_ticks(engine, n, seed, voice, start_rings):
    """``n`` ticks of one session on the single-session engine (random text
    constraints, a pad overwrite every ninth tick), the LM and codec rings
    set to start at ``start_rings`` -> (the packed arrays, host ms of every
    tick)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    engine.begin(seed, voice)
    engine.state["lm"]["t"]["pos"].fill_(start_rings[0])
    engine.mimi_state["dec_t"]["pos"].fill_(start_rings[1])
    out, times = [], []
    for i in range(n):
        mode, tok = int(rng.integers(0, 3)), int(rng.integers(4, 200))
        t0 = time.perf_counter()
        out.append(engine.tick(mode, tok).copy())
        times.append((time.perf_counter() - t0) * 1e3)
        if i % 9 == 8:
            engine.overwrite_last_text_token(engine.cfg.text_pad_token)
    return out, times


SINGLE_TICKS, SINGLE_LM_BEFORE, SINGLE_CODEC_BEFORE = 32, 24, 16


def phase_tts_single(dev, card, tmp, files):
    """configs/config-tts.toml (tts-1.6b, no ``batch_size``: the
    single-session ``TtsEngine``) with its ``voice_dir`` at a directory
    holding a synthetic 10 s ``.wav`` voice (through the speaker encoder).
    Built through ``cli.build_engines`` with its files pointed at
    ``[ckpt]``'s (the tick captured, the default on CUDA), and by
    ``builder.build_tts`` as shipped (the same seeded tree in memory) with
    the eager tick (``cuda_graph=False``); every parameter bit for bit.
    One session with the voice, SINGLE_TICKS ticks from SINGLE_LM_BEFORE
    rows before the LM ring's wrap and SINGLE_CODEC_BEFORE before the codec
    ring's, on both: every tick's packed array bit for bit (so the files
    give the memory's tick, and the graph the eager one), exactly
    PER_TICK_TTS launches a tick on the eager side (the wrappers counted
    from 0 before it to after it; the captured engine's warm-up and capture
    3 x per tick, its replays none).  The captured engine alone then
    synthesises 3 texts with the voice and 1 without: every word back,
    every frame 1,920 finite samples.  Host ms a tick of both, device
    launches and kernel ms a captured tick from a profile; the LM step with
    the voice and the Mimi decode at B=1 through the kernels against their
    plain versions."""
    import torch

    from dsm_tpu_torch import cli
    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import config as CFG
    from dsm_tpu_torch.server.tts_module import TtsEngine
    from dsm_tpu_torch.utils.audio import wav_bytes

    tag = "tts-single"
    path = os.path.join(ROOT, "configs", "config-tts.toml")
    voices = os.path.join(tmp, "voices")
    os.makedirs(voices, exist_ok=True)
    with open(os.path.join(voices, "synthetic.wav"), "wb") as f:
        f.write(wav_bytes(_pcm(3, 10.0, 1920), 24_000))
    counters = _tts_counters(PER_TICK_TTS)
    engines = {}
    for graph in (True, False):
        cfg = CFG.Config.load(path)
        mod = cfg.modules["tts"]
        if graph:
            mod.lm_model_file, mod.audio_tokenizer_file = files["tts"]
        mod.voice_dir = voices
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        eng = cli.build_engines(cfg, dev)["tts"] if graph else \
            builder.build_tts(mod, dev, cuda_graph=False)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(isinstance(eng, TtsEngine) and eng.cuda_graph == graph and eng.ca_quant
              and eng.cfg.kv_quant, f"{tag}: not the single-session card profile")
        eng.warmup()
        if graph:
            load_s = build_s
            launches = {k: fn.launches for k, fn in counters.items()}
            want = {k: 3 * n for k, n in PER_TICK_TTS.items()}
            check(launches == want, f"{tag}: warm-up + capture launched {launches}, want {want}")
        engines[graph] = eng
    check(_params_same(engines[True].params, engines[False].params)
          and _params_same(engines[True].mimi_params, engines[False].mimi_params),
          "ckpt tts: the engine's parameters from the files differ from memory's")
    tcfg = engines[True].cfg.lm.transformer
    check((tcfg.d_model, tcfg.num_layers, tcfg.num_heads, engines[True].mimi_cfg.n_q)
          == (2048, 16, 16, 32) and "batch_size" not in mod.raw, f"{tag}: not tts-1.6b at B=1")
    print(f"[ckpt] configs/config-tts.toml through cli.build_engines from the files: loaded "
          f"and built in {load_s:.2f} s ({_file_size_gb(*files['tts']):.2f} GB; the reads warm: "
          f"the files were just written); every parameter bit for bit that of the engine "
          f"built as shipped (the same seeded tree in memory); the ticks of both below",
          flush=True)
    print(f"[{tag}] {os.path.relpath(path, ROOT)} as shipped but for voice_dir (a synthetic "
          f"10 s wav), captured from [ckpt]'s files and eager from memory: TtsEngine, int8 KV "
          f"ring, int8 voice store, W8A8, bf16 codec", flush=True)
    c_lm = engines[True].state["lm"]["t"]["valid"].shape[1]
    c_dec = engines[True].mimi_state["dec_t"]["valid"].shape[1]
    start = (c_lm - SINGLE_LM_BEFORE, c_dec - SINGLE_CODEC_BEFORE)
    ticks = {}
    for graph in (False, True):
        for fn in counters.values():
            fn.launches = 0
        out, times = _single_ticks(engines[graph], SINGLE_TICKS, 7,
                                   engines[graph].voice_kv("synthetic"), start)
        ticks[graph] = (out, times, {k: fn.launches for k, fn in counters.items()})
    for i, (a, b) in enumerate(zip(ticks[True][0], ticks[False][0])):
        check(a.tobytes() == b.tobytes(), f"{tag}: tick {i} of the captured engine from the "
              f"files differs from the eager engine's from memory")
    decoded = sum(int(a[2]) for a in ticks[True][0])
    past_wrap = int(engines[True].mimi_state["dec_t"]["pos"]) - c_dec  # rows
    check(past_wrap > 0 and int(engines[True].state["lm"]["t"]["pos"])
          == c_lm - SINGLE_LM_BEFORE + SINGLE_TICKS, f"{tag}: {decoded} frames decoded, "
          f"the codec ring did not wrap")
    launches = ticks[False][2]
    want = {k: n * SINGLE_TICKS for k, n in PER_TICK_TTS.items()}
    check(launches == want, f"{tag}: eager launches {launches}, want {want} "
          f"({SINGLE_TICKS} ticks)")
    check(not any(ticks[True][2].values()), f"{tag}: a replay launched a counted kernel")
    eng = engines[True]
    del engines
    torch.cuda.empty_cache()
    texts = [("one two", False), ("hello there", True), ("good day", True),
             ("see you", True)]
    for fn in counters.values():
        fn.launches = 0
    metrics0 = _metric_values()
    res, times = _tts_sessions(eng, texts, "synthetic", 40)
    check(not any(fn.launches for fn in counters.values()),
          f"{tag}: a replay launched a counted kernel")
    frames = _check_tts_sessions(tag, texts, res, eng.mimi_cfg.frame_size)
    _check_metrics(tag, metrics0, {"tts_requests_total": len(texts),
                                   "tts_synthesis_duration_seconds_count": len(texts),
                                   "tts_audio_duration_seconds_total":
                                   sum(pcm.size for pcm, _ in res) / 24_000.0}, dev, card,
                   approx=("tts_audio_duration_seconds_total",))
    stats = {}
    for graph, ts in ((True, times[3:]), (False, ticks[False][1][3:])):
        stats[graph] = (statistics.median(ts), min(ts), max(ts))
    rows, wall_us = _profile(lambda: eng.tick(2, 0), 2,
                             rope_launches=2 * (PER_TICK_TTS["rope_qk"] +
                                                PER_TICK_TTS["rope_commit"]))
    kernel_ms = _print_profile(f"{tag}-profile", "captured: ", rows, wall_us, 2, "tick", card, 6)
    device_launches = sum(c for _, _, c in rows) / 2
    print(f"[{tag}] one session with the wav voice, {SINGLE_TICKS} ticks from "
          f"{SINGLE_LM_BEFORE} rows before the LM ring's wrap ({c_lm} rows) and "
          f"{SINGLE_CODEC_BEFORE} before the codec ring's ({c_dec} rows; {decoded} frames "
          f"decoded, {past_wrap} rows past its wrap): the captured engine from the files bit for "
          f"bit the eager engine from memory at every tick; eager launches {launches} = "
          f"PER_TICK_TTS x {SINGLE_TICKS} ticks", flush=True)
    print(f"[{tag}] the captured engine: {len(texts)} sessions (3 with the wav voice), "
          f"{len(times)} ticks, {frames} frames of 1,920 finite samples, every word back; "
          f"tick host ms, captured: median {stats[True][0]!r} (min {stats[True][1]!r}, max "
          f"{stats[True][2]!r}) over {len(times) - 3} after 3; eager: median "
          f"{stats[False][0]!r} (min {stats[False][1]!r}, max {stats[False][2]!r}) over "
          f"{SINGLE_TICKS - 3} after 3; {device_launches:.0f} device launches and "
          f"{kernel_ms!r} kernel ms a captured tick; card {card}", flush=True)
    phase_tts_path(eng, dev, tag)
    _offline_synthesize_file(eng, tmp, card)
    del eng
    torch.cuda.empty_cache()
    return {"launches": launches, "tick_ms": stats[True], "eager_ms": stats[False],
            "device_launches": device_launches, "kernel_ms": kernel_ms,
            "ticks": SINGLE_TICKS, "load_s": load_s}


ROOM_FRAMES, ROOM_PLAIN_FRAMES = 160, 4  # a room's frames: past the decoder ring's wrap
ROOMS_TOML = """instance_name = "chip-smoke-rooms"

[modules.mimi]
type = "Mimi"
path = "/api/mimi"
n_q = 16
"""


def phase_mimi_rooms(dev, card, tmp):
    """The Mimi rooms as the worker builds them: ROOMS_TOML (one ``type =
    "Mimi"`` module, n_q 16) through ``cli.build_engines`` and
    ``cli.start_engines`` (the warm-up decode) on the card.  Two rooms decode
    ROOM_FRAMES frames each, interleaved, from seeded codes: exactly 8
    ``rope_commit`` launches a frame (the codec transformer's 8 layers) and
    no other counted kernel; each room's pcm bit for bit an independent eager
    ``decode_step`` over the same codes from a fresh state; the first
    ROOM_PLAIN_FRAMES frames within PATH_RTOL of the same steps through the
    plain versions; host ms a frame (``decode_frame`` returns the pcm on the
    host)."""
    import numpy as np
    import torch

    from dsm_tpu_torch import cli
    from dsm_tpu_torch.server import config as CFG
    from dsm_tpu_torch.server.mimi_rooms import MimiRoomsEngine

    tag = "mimi-rooms"
    path = os.path.join(tmp, "rooms.toml")
    with open(path, "w") as f:
        f.write(ROOMS_TOML)
    counters = _duplex_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engines = cli.build_engines(CFG.Config.load(path), dev)
    rooms = engines["mimi_rooms"]
    cli.start_engines(engines)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(isinstance(rooms, MimiRoomsEngine) and rooms.cfg.n_q == 16
          and rooms.device.type == "cuda" and rooms._dtype == torch.bfloat16
          and rooms.cfg.transformer.d_model == 512 and rooms.cfg.transformer.num_layers == 8,
          f"{tag}: not Mimi v0_1 at n_q 16, bf16, on the card")
    warm = {k: fn.launches for k, fn in counters.items()}
    check(warm == {**dict.fromkeys(counters, 0), "rope_commit": 8},
          f"{tag}: the warm-up decode launched {warm}")
    g = np.random.default_rng(11)
    codes = {name: g.integers(0, 2048, (ROOM_FRAMES, 16)).astype(np.int32) for name in "ab"}
    for fn in counters.values():
        fn.launches = 0
    out, ms = {"a": [], "b": []}, []
    for i in range(ROOM_FRAMES):
        for name in "ab":
            t0 = time.perf_counter()
            out[name].append(rooms.decode_frame(rooms.room(name), codes[name][i]))
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in counters.items()}
    check(launches == {**dict.fromkeys(counters, 0), "rope_commit": 8 * 2 * ROOM_FRAMES},
          f"{tag}: {2 * ROOM_FRAMES} frames launched {launches}, want 8 rope_commit a frame")
    ring = rooms.room("a").dec_state["dec_t"]["valid"].shape[1]
    pos = int(rooms.room("a").dec_state["dec_t"]["pos"])
    check(pos > ring, f"{tag}: the decoder ring ({ring} rows) did not wrap ({pos})")
    for name in "ab":
        pcm = np.stack(out[name])
        check(pcm.shape == (ROOM_FRAMES, rooms.cfg.frame_size) and bool(np.isfinite(pcm).all())
              and float(np.abs(pcm).max()) > 0, f"{tag}: room {name}: bad pcm")
        state = rooms.init_state()
        for i in range(ROOM_FRAMES):
            alone, state = rooms.decode(state, codes[name][i])
            check(alone.tobytes() == out[name][i].tobytes(), f"{tag}: room {name} frame {i} "
                  f"differs from an independent decode_step over the same codes")
    before = {k: fn.launches for k, fn in counters.items()}
    errs, exact = [], True
    with plain_seams():
        state = rooms.init_state()
        for i in range(ROOM_PLAIN_FRAMES):
            plain, state = rooms.decode(state, codes["a"][i])
            errs.append(_rel(torch.from_numpy(out["a"][i]), torch.from_numpy(plain)))
            exact = exact and plain.tobytes() == out["a"][i].tobytes()
    check(all(fn.launches == before[k] for k, fn in counters.items()),
          f"{tag}: the plain decode launched a counted kernel")
    check(max(errs) < PATH_RTOL, f"{tag}: the first frames against the plain versions: "
          f"relative L2 {errs}, bar {PATH_RTOL}")
    frame_ms = (statistics.median(ms[4:]), max(ms[4:]))
    print(f"[{tag}] {os.path.basename(path)} (one Mimi module, n_q 16) through "
          f"cli.build_engines and start_engines in {build_s:.2f} s: Mimi v0_1, bf16, warm-up "
          f"decode {warm['rope_commit']} rope_commit; 2 rooms x {ROOM_FRAMES} frames "
          f"interleaved, the decoder ring of {ring} rows at tick {pos}: {launches['rope_commit']} "
          f"rope_commit launches = 8 a frame, no other counted kernel; each room's pcm bit for "
          f"bit an independent decode_step from a fresh state; the first {ROOM_PLAIN_FRAMES} "
          f"frames against the plain versions: relative L2 max {max(errs)!r} (bit for bit: "
          f"{exact}); host ms a frame median {frame_ms[0]!r}, max {frame_ms[1]!r} over "
          f"{len(ms) - 4} after 4 (the frame is 80 ms); card {card}", flush=True)
    del rooms, engines
    torch.cuda.empty_cache()
    return {"launches": launches, "frame_ms": frame_ms}


def phase_tune(dev):
    """Path C: the tuning tool in process, as ``python -m
    dsm_tpu_torch.tools.attn_kernel_tune --batch 64`` runs it: every variant a
    row with its device ms, GB/s and max error against
    ``attend_global_split_q``, held to TUNE_REL_BARS as a share of that
    reference's largest output; a variant that fails to build or launch
    fails the run.  Returns the launches of attn_tune and decode_attend."""
    from dsm_tpu_torch.ops import attn_tune as AT
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.tools import attn_kernel_tune as TOOL

    variants = TOOL.DEFAULT_VARIANTS.split(",")
    AT.attn_tune.launches = 0
    DA.decode_attend.launches = 0
    summary = TOOL.run(64, variants, dev)
    launches = {"attn_tune": AT.attn_tune.launches, "decode_attend": DA.decode_attend.launches}
    for row in summary["results"]:
        print(f"[tune] {json.dumps(row)}", flush=True)
        check("error" not in row, f"tune: variant {row['variant']} failed: {row.get('error')}")
        bar = TUNE_REL_BARS[row["variant"].partition("_")[2]]
        check(row["ms"] > 0 and row["rel_err"] <= bar,
              f"tune: variant {row['variant']} is {row['rel_err']!r} of the largest output "
              f"from attend_global_split_q (bar {bar})")
    bb = {r["variant"]: r["max_err"] for r in summary["results"]
          if r["variant"].startswith("bb") and "_" not in r["variant"]}
    check(len(set(bb.values())) == 1, f"tune: the bb variants' errors differ: {bb}")
    check(summary["ref_max"] > 0.1, f"tune: a reference of at most {summary['ref_max']!r}")
    print(f"[tune] {json.dumps({k: v for k, v in summary.items() if k != 'results'})}; "
          f"launches {launches} (each variant once to check it, 21 times to time it)",
          flush=True)
    check(launches["attn_tune"] == 22 * (len(variants) - 1) and launches["decode_attend"] == 22,
          f"tune: launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# The Moshi 7B family and the offline entry points
# ---------------------------------------------------------------------------

# Launches per tick of Moshi 7B in the dialogue layout (moshi_v0_1_streaming(8),
# build_duplex's default model): 32 heads x 128 over a 3,072-row int8 ring are
# not a shape of the fused commit, so each of the LM's 32 layers takes the split
# pipeline; the Mimi encoder's and decoder's 8 layers rotate and commit their
# bf16 rows.
PER_TICK_MOSHI = {"rope_qk": 32, "quantize_commit": 32, "decode_attend": 32, "rope_commit": 16,
                  "quantize_scale_commit": 0, "decode_attend_commit": 0, **_NONE}
MOSHI_RING = (24, 32, 3072, 128)
GEN_RING = (1, 32, 3008, 128)  # cli gen's bf16 LM rings (moshi_v0_1_streaming(), B=1)
LEGACY_RING = (2, 32, 4096, 64)  # the legacy TTS's bf16 LM rings (tts_v0_1, guidance)
MOSHI_SINGLE_TICKS = 6  # frames the single-dialogue engine runs
GEN_STEPS, GEN_CHUNK = 64, 16  # cli gen's steps, and the chunk held to chunk 1
LEGACY_STEPS = 40  # steps of the legacy TTS, guidance on
OFFLINE_SEEDED_S = 6.0  # the seeded file beside audio/speech-synthetic.wav
# VAD probabilities of one file at B=2 and at B=1, words and steps equal.  The
# gap is the batch shape's: [offline] holds the captured B=2 run bit for bit to
# the eager B=2 step and the two rows of one file twice at B=2 bit for bit to
# each other, so neither the capture nor the other row moves a row; the eager
# B=2 and B=1 steps differ as much (bf16 products of another M take other
# cuBLAS kernels, then 16 layers of int8-quantised activations).  0.015351004898548126
# in four runs, NVIDIA H100 80GB HBM3, 700 W; the bar keeps a third over it.
OFFLINE_PRS_ATOL = 2e-2


def phase_moshi_duplex(dev, card, tmp):
    """``build_duplex`` on a TOML whose ``type = "Lm"`` module names no
    ``[model]``: the default, Moshi 7B in the dialogue layout
    (``moshi_v0_1_streaming(8)``: d=4096, 32 layers of 32 heads x 128, 16
    codebooks in, 8 generated), at full width with seeded random weights;
    ``batch_size = 24``, ``pipeline_depth = 2``, ``kv_quant = true``,
    ``kv_bits = 8``.  The captured engine: its kernels counted over warm-up
    and capture (3 x PER_TICK_MOSHI), its tick timed (host ms, completion to
    completion, busy, launches, kernel ms, peak memory), the largest batch
    ``auto_batch_size`` fits, and the replay held to the eager tick bit for bit
    over GRAPH_DUPLEX_TICKS["moshi-duplex"] ticks past every ring's wrap.  Then
    the single-dialogue ``DuplexEngine`` (no ``batch_size``) on the same
    weights: MOSHI_SINGLE_TICKS frames, every launch counted, host ms a frame.
    Returns the numbers and the launches."""
    import numpy as np
    import torch

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import config as CFG
    from dsm_tpu_torch.server.autoconfig import auto_batch_size, device_memory_bytes
    from dsm_tpu_torch.server.duplex import DuplexEngine, DuplexSession

    tag = "moshi-duplex"
    path = os.path.join(tmp, "moshi-duplex.toml")
    with open(path, "w") as f:
        f.write('[modules.duplex]\ntype = "Lm"\npath = "/api/chat"\nbatch_size = 24\n'
                "pipeline_depth = 2\nkv_quant = true\nkv_bits = 8\n")
    mod = CFG.Config.load(path).modules["duplex"]
    check(mod.lm is None and builder.duplex_model(mod) == LM.moshi_v0_1_streaming(8),
          f"{tag}: the default model is not moshi_v0_1_streaming(8)")
    counters = _duplex_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = builder.build_duplex(mod, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lm = engine.cfg.lm
    tcfg = lm.transformer
    ring = engine.state["lm"]["t"]["layers"][0]
    check(lm == LM.moshi_v0_1_streaming(8) and engine.batch_size == 24
          and (engine.cfg.generated_audio_codebooks, engine.cfg.input_audio_codebooks) == (8, 8)
          and engine.pipeline_depth == 2 and engine.cuda_graph and engine.kv_quant,
          f"{tag}: not the default model at B=24, depth 2, captured, int8 rings")
    check(ring["k"].dtype == torch.int8 and tuple(ring["k"].shape) == MOSHI_RING
          and len(engine.state["lm"]["t"]["layers"]) == 32,
          f"{tag}: rings {tuple(ring['k'].shape)} {ring['k'].dtype}, not {MOSHI_RING} int8")
    check(isinstance(engine.params["lm"]["transformer"][0]["in_proj_w"], dict),
          f"{tag}: LM weights not int8")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 3 * n for name, n in PER_TICK_MOSHI.items()}
    check(launches == want, f"{tag}: warm-up + capture launched {launches}, want {want}")
    print(f"[{tag}] {os.path.basename(path)}: type = \"Lm\" with no [model] -> "
          f"moshi_v0_1_streaming(8) (d={tcfg.d_model}, {tcfg.num_layers} layers of "
          f"{tcfg.num_heads} x {tcfg.hd}, ff {tcfg.dim_feedforward}, context {tcfg.context}, "
          f"{lm.audio_codebooks} codebooks in, DepFormer {lm.depformer.num_slices} slices), "
          f"B=24, pipeline_depth 2, int8 rings {MOSHI_RING} + W8A8, bf16 codec, seeded random "
          f"weights: built in {build_s:.2f} s ({weights_gb:.2f} GB allocated after the build), "
          f"warm-up and capture {capture_s:.2f} s; kernel launches counted over them "
          f"{launches} = 3 x per tick; card {card}", flush=True)
    rope = PER_TICK_MOSHI["rope_qk"] + PER_TICK_MOSHI["rope_commit"]
    numbers = {"graph": _duplex_graph_times(engine, tag, "captured: ", card, rope)}
    numbers["fit"] = auto_batch_size(10 ** 6, lm, device_memory_bytes(dev))
    print(f"[{tag}] auto_batch_size: the largest batch of this model that fits this card is "
          f"{numbers['fit']} (24 served); card {card}", flush=True)
    _duplex_against_eager(engine, tag, dev, seed=49)
    params, mimi_cfg, mimi_params, tokenizer = (engine.params, engine.mimi_cfg,
                                                engine.mimi_params, engine.tokenizer)
    cfg = engine.cfg
    del engine, ring
    torch.cuda.empty_cache()

    single = DuplexEngine(cfg, params, mimi_cfg, mimi_params, tokenizer, kv_quant=True,
                          device=dev)
    for fn in counters.values():
        fn.launches = 0
    sess = DuplexSession(single, seed=3)
    pcm = _pcm(21, 0.08 * MOSHI_SINGLE_TICKS, mimi_cfg.frame_size)
    audio, times, text_acc = [], [], []
    for i in range(MOSHI_SINGLE_TICKS):
        t0 = time.perf_counter()
        sess._frame(pcm[i * mimi_cfg.frame_size:(i + 1) * mimi_cfg.frame_size], audio.append,
                    lambda text: None, text_acc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    single_launches = {name: fn.launches for name, fn in counters.items()}
    decoded = MOSHI_SINGLE_TICKS - cfg.acoustic_delay
    want = {name: MOSHI_SINGLE_TICKS * n for name, n in PER_TICK_MOSHI.items()}
    want["rope_commit"] = 8 * (MOSHI_SINGLE_TICKS + decoded)  # decode only once a frame is out
    check(single_launches == want, f"{tag}: single dialogue launched {single_launches}, "
          f"want {want}")
    check(len(audio) == decoded and all(a.shape == (1920,) and np.isfinite(a).all()
                                        for a in audio), f"{tag}: single dialogue's audio")
    state_ring = sess.state["lm"]["t"]["layers"][0]["k"]
    check(tuple(state_ring.shape) == (1, 32, 3072, 128) and state_ring.dtype == torch.int8,
          f"{tag}: the single dialogue's ring {tuple(state_ring.shape)}")
    numbers["single_ms"] = (statistics.median(times[1:]), max(times[1:]))
    # Which route the W8A8 sites take at one row (torch._int_mm wants more than
    # 16): a profile of one more frame.
    rows, wall_us = _profile(lambda: sess._frame(pcm[:mimi_cfg.frame_size], audio.append,
                                                 lambda text: None, text_acc), 1)
    _print_profile(f"{tag}-single-profile", "B=1 frame, eager: ", rows, wall_us, 1, "frame",
                   card, 6)
    int8_gemms = sorted({key for key, _, _ in rows if "s8" in key or "int8" in key})
    check(bool(int8_gemms), f"{tag}: no int8 GEMM in the single dialogue's frame")
    print(f"[{tag}] W8A8 at B=1: the row padded to 17, torch._int_mm's int8 GEMM kernels "
          f"{[k[:80] for k in int8_gemms]}", flush=True)
    print(f"[{tag}] the single-dialogue DuplexEngine (no batch_size; the same weights, int8 "
          f"rings (1, 32, 3072, 128), eager, W8A8 through torch._int_mm with the row padded to "
          f"its 17-row minimum): {MOSHI_SINGLE_TICKS} frames, {len(audio)} decoded; host ms a "
          f"frame median {numbers['single_ms'][0]!r}, max {numbers['single_ms'][1]!r} (the first "
          f"excluded); launches {single_launches}; peak memory "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved over the phase; card {card}",
          flush=True)
    total = {name: launches[name] + single_launches[name] for name in launches}
    del single, sess, params, mimi_params
    torch.cuda.empty_cache()
    return numbers, total


def phase_gen(dev, card, tmp):
    """``cli gen`` at its default preset (``moshi_v0_1_streaming()``: Moshi 7B,
    16 codebooks in, 16 slices; bf16 weights from the seed and bf16 rings
    (1, 32, 3008, 128), B=1): ``python -m dsm_tpu_torch.cli gen --steps 2
    --trace DIR --out-tokens FILE`` in process (its JSON line, its tokens
    file, its Chrome trace parsed, with the card's kernels in it); then the
    same seeded model through ``lm_gen_simple.generate`` over GEN_STEPS steps
    at ``chunk`` 1 and GEN_CHUNK: the same tokens (and the CLI's first two),
    every frame in range, ms a step, every launch counted."""
    import io

    import numpy as np
    import torch

    from dsm_tpu_torch import cli
    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.sessions import lm_gen_simple as G
    from dsm_tpu_torch.utils.checkpoint import load_safetensors

    tag = "gen"
    counters = _duplex_counters()
    tokens_path = os.path.join(tmp, "gen.safetensors")
    trace_dir = os.path.join(tmp, "gen-trace")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["gen", "--steps", "2", "--seed", "0", "--trace", trace_dir,
                       "--out-tokens", tokens_path])
    cli_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and set(line) == {"text_tokens", "audio_frames", "codebooks"}
          and len(line["text_tokens"]) == 2, f"{tag}: the CLI's JSON line {line}")
    saved = load_safetensors(tokens_path)
    check(saved.get("text_tokens").tolist() == line["text_tokens"],
          f"{tag}: the tokens file differs from the printed tokens")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(any("rope_commit" in e.get("name", "") for e in kernels),
          f"{tag}: the trace holds no rope_commit kernel ({len(kernels)} kernel events)")
    print(f"[{tag}] python -m dsm_tpu_torch.cli gen --steps 2 --trace DIR --out-tokens FILE "
          f"(default preset moshi_v0_1_streaming, --device cuda): rc 0 in {cli_s:.1f} s, its "
          f"JSON line {line}; the tokens file read back; the Chrome trace parses: "
          f"{len(events)} events, {len(kernels)} kernel events on the card", flush=True)

    lm_cfg = LM.moshi_v0_1_streaming()
    n = lm_cfg.generated_codebooks
    cfg = G.GenConfig(lm=lm_cfg, audio_delays=tuple([0] + [2] * (n - 1)),
                      text_start_token=lm_cfg.text_start_token, max_steps=GEN_STEPS + 8)
    t0 = time.perf_counter()
    params = {"lm": LM.init(lm_cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16)}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    runs = {}
    for chunk in (1, GEN_CHUNK):
        t0 = time.perf_counter()
        runs[chunk] = G.generate(cfg, params, GEN_STEPS, seed=0, chunk=chunk)
        runs[chunk] += ((time.perf_counter() - t0) * 1e3 / GEN_STEPS,)
    launches = {name: fn.launches for name, fn in counters.items()}
    (t1, f1, ms1), (t16, f16, ms16) = runs[1], runs[GEN_CHUNK]
    # Where a step's time goes: the f32 copies of every bf16 ring that the
    # attention makes (attention.attend_global_split, ROADMAP queue 2 item H).
    state = G.init_state(cfg, device=dev)
    free = torch.full((n,), G.FREE, dtype=torch.int32, device=dev)
    text = torch.tensor(G.FREE, dtype=torch.int32, device=dev)
    key = G.step_keys(1, 1)[0].to(dev)
    with torch.inference_mode():
        rows, wall_us = _profile(lambda: G.step(cfg, params, state, key, text, free), 1)
    kernel_ms = _print_profile(f"{tag}-profile", "B=1 step, eager: ", rows, wall_us, 1, "step",
                               card, 6)
    copy_ms = sum(us for key_, us, _ in rows if "direct_copy" in key_) / 1e3
    print(f"[{tag}] a step's device time {kernel_ms!r} ms, of which direct_copy_kernel "
          f"{copy_ms!r} ms (the f32 copies of the bf16 rings among them), "
          f"{sum(c for _, _, c in rows):.0f} device launches; card {card}", flush=True)
    del state
    check(t1 == t16 and np.array_equal(f1, f16), f"{tag}: chunk 1 and {GEN_CHUNK} differ")
    check(t1[:2] == line["text_tokens"], f"{tag}: the first tokens differ from the CLI's")
    check(f1.shape == (GEN_STEPS - 2, n) and int(f1.min()) >= 0
          and int(f1.max()) < lm_cfg.audio_vocab_size - 1
          and all(0 <= t < lm_cfg.text_out_vocab_size for t in t1),
          f"{tag}: frames {f1.shape} or tokens out of range")
    ring = tuple(LM.init_state(lm_cfg, 1, device="meta")["t"]["layers"][0]["k"].shape)
    check(ring == GEN_RING, f"{tag}: rings {ring}, the kernel cases hold {GEN_RING}")
    want = {name: 0 for name in counters}
    want["rope_commit"] = 2 * GEN_STEPS * lm_cfg.transformer.num_layers
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    print(f"[{tag}] moshi_v0_1_streaming() (the CLI's seeded bf16 weights, built in "
          f"{build_s:.2f} s), B=1, bf16 rings {ring}: {GEN_STEPS} steps at chunk 1 and "
          f"{GEN_CHUNK}, the same {len(t1)} text tokens and {f1.shape[0]} frames of {n} "
          f"codebooks (the CLI's first two tokens too), every token in range; ms a step "
          f"{ms1!r} at chunk 1, {ms16!r} at chunk {GEN_CHUNK} (one fetch a chunk); launches "
          f"{launches}: 32 rope_commit a step, the LM's bf16 rings; peak memory "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved; card {card}", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"ms": (ms1, ms16)}, launches


def phase_tts_legacy(dev, card):
    """The legacy T5-conditioned TTS at ``tts_v0_1`` (48 layers of 32 heads x
    64, LayerNorm, a GELU MLP, context 4096, cross-attention; DepFormer 16 x
    6) with seeded bf16 weights: T5-shaped states (1, 24, 768) through a
    random ``t5_proj`` and a seeded 10 s speaker sample through Mimi v0_1's
    encoder (``conditions``, guidance rows), then LEGACY_STEPS steps with
    guidance on (bf16 rings (2, 32, 4096, 64)): every written frame in range,
    ms a step, every launch counted; then ``sample`` for a few steps."""
    import torch

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.models import mimi as MIMI
    from dsm_tpu_torch.ops import sampling as S
    from dsm_tpu_torch.ops import transformer as T
    from dsm_tpu_torch.sessions import tts_legacy as LT

    tag = "tts-legacy"
    counters = _duplex_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm_cfg, mimi_cfg = LM.tts_v0_1(), MIMI.v0_1(16)
    cfg = LT.LegacyTtsConfig(lm=lm_cfg, mimi=mimi_cfg)
    g = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    params = {"lm": LM.init(lm_cfg, g, dtype=torch.bfloat16),
              "mimi": MIMI.init(mimi_cfg, g, dtype=torch.bfloat16)}
    text_states = torch.randn(1, 24, 768, generator=g, device=dev)
    t5_proj = torch.randn(768, lm_cfg.d_model, generator=g, device=dev) * 768 ** -0.5
    speaker_proj = torch.randn(mimi_cfg.seanet.dimension, lm_cfg.d_model, generator=g,
                               device=dev) * mimi_cfg.seanet.dimension ** -0.5
    speaker = torch.from_numpy(_pcm(13, 10.0, 1920)).to(dev, torch.bfloat16)[None, None]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.inference_mode():
        t0 = time.perf_counter()
        src = LT.conditions(cfg, params, text_states, t5_proj, speaker, speaker_proj)
        torch.cuda.synchronize()
        cond_s = time.perf_counter() - t0
        check(tuple(src.shape) == (2, 24 + 2 * 125, lm_cfg.d_model)
              and bool(torch.isfinite(src).all()), f"{tag}: source {tuple(src.shape)}")
        ca_kv = T.precompute_ca_kv(lm_cfg.transformer, params["lm"]["transformer"], src)
        state = LT.init_state(cfg, 2, device=dev)
        ring = state["lm"]["t"]["layers"][0]["k"]
        check(tuple(ring.shape) == LEGACY_RING and ring.dtype == torch.bfloat16,
              f"{tag}: rings {tuple(ring.shape)} {ring.dtype}")
        for fn in counters.values():
            fn.launches = 0
        rng = S.prng_key(11)
        times, eog = [], None
        for i in range(LEGACY_STEPS):
            rng, sub = S.split(rng.cpu())
            t0 = time.perf_counter()
            out, state = LT.step(cfg, params, state, sub.to(dev), ca_kv, cfg_alpha=3.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if eog is None and bool(out["end_of_gen"]):
                eog = i
        launches = {name: fn.launches for name, fn in counters.items()}
        buf = state["audio_tokens"][:LEGACY_STEPS - LT.ACOUSTIC_DELAY]
        check(bool(((buf >= 0) & (buf < lm_cfg.audio_vocab_size - 1)).all())
              and bool((state["audio_tokens"][LEGACY_STEPS:] == LT.UNSET).all()),
              f"{tag}: a written frame out of range")
        want = {name: 0 for name in counters}
        want["rope_commit"] = LEGACY_STEPS * lm_cfg.transformer.num_layers
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        t0 = time.perf_counter()
        frames = LT.sample(cfg, params, src, seed=5, cfg_alpha=3.0, max_steps=8)
        sample_s = time.perf_counter() - t0
        check(frames.shape[1] == 16 and (frames < cfg.quantizer_bins).all(),
              f"{tag}: sample gave {frames.shape}")
    ms = statistics.median(times[2:])
    print(f"[{tag}] tts_v0_1 (d=2048, 48 layers of 32 x 64, LayerNorm, GELU MLP, context 4096, "
          f"cross-attention; DepFormer 16 x 6), seeded bf16 weights built in {build_s:.2f} s; "
          f"conditions: T5-shaped states (1, 24, 768) and a 10 s speaker sample through Mimi "
          f"v0_1 -> source {tuple(src.shape)} in {cond_s:.2f} s; {LEGACY_STEPS} steps with "
          f"guidance (cfg_alpha 3.0, 2 rows), bf16 rings (2, 32, 4096, 64): ms a step median "
          f"{ms!r} (min {min(times[2:])!r}, max {max(times[2:])!r}, the first 2 excluded); "
          f"every written frame in range (end of generation first at step {eog}); launches "
          f"{launches}; sample(max_steps=8) kept {frames.shape[0]} frames in {sample_s:.2f} s; "
          f"peak memory {torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved; card {card}",
          flush=True)
    del params, state, ca_kv
    torch.cuda.empty_cache()
    return {"ms": ms}, launches


def _offline_synthesize_file(engine, tmp, card):
    """``offline.synthesize_file`` through ``[tts-single]``'s captured engine:
    the wav written, every word back, its duration that of the samples."""
    from dsm_tpu_torch import offline
    from dsm_tpu_torch.utils.audio import read_wav

    text = "hello there good friend"
    out = os.path.join(tmp, "offline-tts.wav")
    t0 = time.perf_counter()
    res = offline.synthesize_file(text, out, engine=engine)
    took = time.perf_counter() - t0
    pcm, sr = read_wav(out)
    check(sr == 24_000 and len(pcm) > 0 and res["duration_s"] == round(len(pcm) / 24_000.0, 3)
          and [w["text"] for w in res["transcript"]] == text.split(),
          f"[offline] synthesize_file: {res}")
    print(f"[offline] synthesize_file through [tts-single]'s captured engine (tts-1.6b, B=1): "
          f"{len(res['transcript'])} words, {res['duration_s']} s of audio in {took:.2f} s "
          f"(realtime factor {res['duration_s'] / took:.2f}x); card {card}", flush=True)


def _offline_synthesize_jsonl(engine, card):
    """``offline.synthesize_jsonl`` on the first 3 lines of audio/tts.jsonl
    through ``[graph-tts-serving]``'s engine (fuse 4, depth 2, captured), its
    model loop started and stopped by the call: one wav a line, in order."""
    from dsm_tpu_torch import offline
    from dsm_tpu_torch.utils.audio import read_wav

    with open(os.path.join(ROOT, "audio", "tts.jsonl")) as f:
        lines = [ln for ln in f if ln.strip()][:3]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-jsonl-") as tmp:
        src = os.path.join(tmp, "in.jsonl")
        with open(src, "w") as f:
            f.writelines(lines)
        t0 = time.perf_counter()
        manifest = offline.synthesize_jsonl(src, os.path.join(tmp, "out"), engine=engine)
        took = time.perf_counter() - t0
        ids = [json.loads(ln)["id"] for ln in lines]
        check([m["id"] for m in manifest] == ids and not engine.running,
              f"[offline] synthesize_jsonl: {manifest}")
        for m in manifest:
            pcm, sr = read_wav(m["out"])
            check(sr == 24_000 and len(pcm) > 0 and m["words"] > 0
                  and m["duration_s"] == round(len(pcm) / 24_000.0, 3),
                  f"[offline] synthesize_jsonl: {m}")
    print(f"[offline] synthesize_jsonl on audio/tts.jsonl's first {len(lines)} lines through "
          f"[graph-tts-serving]'s engine (B=64, fuse 4, depth 2, captured): "
          f"{[(m['id'], m['words'], m['duration_s']) for m in manifest]} in {took:.2f} s; "
          f"card {card}", flush=True)


def phase_offline(dev, card, tmp):
    """``offline.transcribe_files`` at configs/config-stt.toml (stt-1b, int8
    rings, W8A8, seeded random weights; ``build_asr_engine`` as ``cli stt
    --config`` builds it) on audio/speech-synthetic.wav and a seeded
    OFFLINE_SEEDED_S s wav: both files on the batch dimension, K = 50 frames a
    dispatch, one captured step replayed; bit for bit the eager B=2 step,
    and one file twice at B=2 gives two equal rows; each result equal to
    ``transcribe_file`` of that file (B=1, captured) and to the
    frame-at-a-time path (eager), words and VAD steps, the probabilities
    within OFFLINE_PRS_ATOL between batch shapes and bit for bit between the
    captured and eager B=1 paths; the realtime factor; every launch counted
    (3 x PER_STEP a capture, PER_STEP an eager step).  The mp3 sample is
    decoded where libmpg123 loads."""
    import numpy as np
    import torch

    from dsm_tpu_torch import offline
    from dsm_tpu_torch.utils import codecs
    from dsm_tpu_torch.utils.audio import decode_audio, write_wav

    tag = "offline"
    counters = {name: _duplex_counters()[name] for name in PER_STEP}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = offline.build_asr_engine(os.path.join(ROOT, "configs", "config-stt.toml"),
                                      device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(engine.cfg.kv_quant and engine.cfg.lm.transformer.num_layers == 16
          and engine.batch_size == 1, f"{tag}: not the stt-1b card profile")
    seeded = os.path.join(tmp, "seeded.wav")
    write_wav(seeded, _pcm(17, OFFLINE_SEEDED_S, 1920), 24_000)
    paths = [os.path.join(ROOT, "audio", "speech-synthetic.wav"), seeded]
    audio_s = sum(len(decode_audio(p)) / 24_000.0 for p in paths)
    t0 = time.perf_counter()
    first = offline.transcribe_files(paths, engine=engine, vad=True)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched = offline.transcribe_files(paths, engine=engine, vad=True)
    batched_s = time.perf_counter() - t0
    check(batched == first, f"{tag}: a second batched run differs from the first")
    # Witnesses of where a B=2 row's probabilities part from B=1's: not in the
    # capture (the eager B=2 step gives the same bits), not from the other row
    # (one file twice: two equal rows).
    eager2 = offline.transcribe_files(paths, engine=engine, vad=True, cuda_graph=False)
    check(eager2 == batched, f"{tag}: the captured B=2 run differs from the eager B=2 step")
    twin = offline.transcribe_files(paths[:1] * 2, engine=engine, vad=True)
    check(twin[0] == twin[1], f"{tag}: one file twice at B=2 gives two different rows")
    frames = 0
    worst = 0.0
    for p, r in zip(paths, batched):
        solo = offline.transcribe_file(p, engine=engine, vad=True)
        eager = offline.transcribe_per_frame(p, engine, vad=True)
        check(solo == eager, f"{tag}: {os.path.basename(p)}: the captured B=1 path differs "
              f"from the frame-at-a-time path")
        check(r["words"] == solo["words"] and r["text"] == solo["text"]
              and [v["step_idx"] for v in r["vad"]] == [v["step_idx"] for v in solo["vad"]],
              f"{tag}: {os.path.basename(p)}: the batched words or steps differ")
        diff = np.abs(np.asarray([v["prs"] for v in r["vad"]])
                      - np.asarray([v["prs"] for v in solo["vad"]]))
        worst = max(worst, float(diff.max()))
        check(worst <= OFFLINE_PRS_ATOL, f"{tag}: VAD probabilities {worst!r} apart")
        frames += len(r["vad"])
    launches = {name: fn.launches for name, fn in counters.items()}
    # 5 captures (a call's step lives for the call): the two B=2 runs, the
    # twin and the two files alone; the eager B=2 run's steps and the
    # frame-at-a-time path's frames.
    eager_steps = max(len(r["vad"]) for r in batched) + frames
    want = {name: (3 * 5 + eager_steps) * n for name, n in PER_STEP.items()}
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    mp3 = os.path.join(ROOT, "audio", "speech-synthetic.mp3")
    if codecs.mp3_available():
        mp3_note = f"decoded: {len(decode_audio(mp3)) / 24_000.0:.3f} s"
    else:
        mp3_note = "not decoded: libmpg123 does not load on this machine"
    print(f"[{tag}] configs/config-stt.toml through offline.build_asr_engine ({build_s:.2f} s): "
          f"transcribe_files on {', '.join(os.path.basename(p) for p in paths)} "
          f"({audio_s:.3f} s of audio, {frames} frames with the flush, B=2, 50 frames a "
          f"dispatch): {first_s:.3f} s the first call, {batched_s:.3f} s the second, each capturing "
          f"its step (realtime factor {audio_s / batched_s:.2f}x); words {[len(r['words']) for r in batched]}; each equal to "
          f"transcribe_file (B=1, captured) and the frame-at-a-time path (eager, bit for bit "
          f"the captured B=1 one); the captured B=2 run bit for bit the eager B=2 step, and "
          f"one file twice at B=2 two equal rows; VAD probabilities within {worst!r} between "
          f"B=2 and B=1 (bar {OFFLINE_PRS_ATOL}); launches {launches} (5 captures x 3 steps + "
          f"{eager_steps} eager steps); "
          f"speech-synthetic.mp3 {mp3_note}; card {card}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return {"rtf": audio_s / batched_s}, launches


# ---------------------------------------------------------------------------
# Training: the step at tts-1.6b's full width, and its path through the plain
# versions
# ---------------------------------------------------------------------------


def _tts16_lm():
    """configs/config-tts.toml's model (tts-1.6b) as the TTS builder reads it."""
    from dsm_tpu_torch.server import config as CFG

    return CFG.Config.load(os.path.join(ROOT, "configs/config-tts.toml")).modules["tts"].lm


def _train_batch(lm_cfg, dev, seed):
    """TRAIN_BATCH sequences of TRAIN_FRAMES frames of random tokens from a
    seeded generator on the card: text in the output vocabulary, audio below
    the pad token, as many audio columns as codebooks and slices need."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    k = max(lm_cfg.audio_codebooks, lm_cfg.generated_codebooks)
    shape = (TRAIN_BATCH, TRAIN_FRAMES)
    return {"text": torch.randint(0, lm_cfg.text_out_vocab_size, shape, generator=g,
                                  device=dev, dtype=torch.int32),
            "audio": torch.randint(0, lm_cfg.audio_vocab_size - 1, (*shape, k), generator=g,
                                   device=dev, dtype=torch.int32)}


def _train_counters():
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import qmm as QM
    from dsm_tpu_torch.ops import ring_kernels as RK

    return {**_duplex_counters(), "ring_commit_backward": RK.ring_commit_backward,
            "ca_decode_attend": DA.ca_decode_attend, "qmm": QM.qmm}


def phase_train(dev, card):
    """``[train]``: ``train.make_train_step`` on configs/config-tts.toml's
    tts-1.6b at full width (temporal 16 layers of d=2048 with the voice
    cross-attention, which the loss leaves without gradient; DepFormer 32
    slices x 4 layers of d=1024, low-rank 128), f32 weights from
    ``LM.init`` on a seeded generator on the card, B=2 x 128 frames of
    seeded tokens: one step to warm up, then TRAIN_STEPS steps on the same
    batch, each loss finite and the last below the first; exactly 128
    ``ring_commit`` and 128 ``ring_commit_backward`` launches a step (32
    slices x 4 layers into the (256, 16, 32, 64) f32 ring) and no other
    counted kernel; median step ms, peak memory reserved and the parameter
    count."""
    import torch

    from dsm_tpu_torch import train as TR
    from dsm_tpu_torch.models import lm as LM

    tag = "train"
    counters = _train_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm_cfg = _tts16_lm()
    dep = lm_cfg.depformer
    per_step = dep.num_slices * dep.transformer.num_layers
    cfg = TR.TrainConfig(lm=lm_cfg)
    t0 = time.perf_counter()
    params = LM.init(lm_cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.float32)
    n_params = sum(p.numel() for p in TR.leaves(params))
    n_ca = sum(x.numel() for layer in params["transformer"] for key, p in layer.items()
               if key.startswith("ca_") or key == "norm_cross" for x in TR.leaves(p))
    opt = TR.make_optimizer(cfg)
    state = opt.init(params)
    step = TR.make_train_step(cfg, opt)
    batch = _train_batch(lm_cfg, dev, 5)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    losses, times, aux = [], [], None
    for i in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, aux = step(params, state, batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        got = {name: fn.launches for name, fn in counters.items()}
        want = {name: 0 for name in counters}
        want["ring_commit"] = want["ring_commit_backward"] = (i + 1) * per_step
        check(got == want, f"{tag}: launches after step {i} {got}, want {want}")
    launches = {name: fn.launches for name, fn in counters.items()}
    ring = DEPFORMER_RING
    check(all(math.isfinite(x) for x in losses), f"{tag}: a loss is not finite: {losses}")
    check(losses[-1] < losses[1], f"{tag}: the loss did not fall: {losses}")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_reserved() / 1e9
    # Where a step's time goes: its halves on the host's clock, then one step
    # under the profiler (device time by kernel, launches, busy share).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, _ = TR.loss_fn(cfg, params, batch)
        loss.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.step(params, state)
    torch.cuda.synchronize()
    halves = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
    rows, wall_us = _profile(lambda: step(params, state, batch), 1, rope_launches=0)
    kernel_ms = _print_profile(f"{tag}-profile", "", rows, wall_us, 1, "step", card, 12)
    print(f"[{tag}-profile] loss and backward {halves[0]!r} ms, optimizer {halves[1]!r} ms "
          f"(host clock, one step); card {card}", flush=True)
    tf = lm_cfg.transformer
    print(f"[{tag}] tts-1.6b (configs/config-tts.toml: temporal {tf.num_layers} layers of "
          f"d={tf.d_model}, DepFormer "
          f"{dep.num_slices} slices x {dep.transformer.num_layers} layers of d="
          f"{dep.transformer.d_model}, low-rank {dep.low_rank_embeddings}), f32, {n_params:,} "
          f"parameters ({n_params - n_ca:,} without the cross-attention, which gets no "
          f"gradient), built with the optimizer state in {build_s:.2f} s; B={TRAIN_BATCH} x "
          f"{TRAIN_FRAMES} frames, the DepFormer ring {ring} f32; losses {losses} (the first "
          f"the warm-up step; text {float(aux['text_loss'])!r}, audio "
          f"{float(aux['audio_loss'])!r} at the last); step ms median {ms!r} (min "
          f"{min(times)!r}, max {max(times)!r}) over {TRAIN_STEPS}; launches {launches} = "
          f"{per_step} ring_commit + {per_step} ring_commit_backward a step; peak memory "
          f"{peak:.2f} GB reserved; card {card}", flush=True)
    del params, state, batch
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gb": peak, "params": n_params, "losses": losses,
            "halves": halves, "kernel_ms": kernel_ms}, launches


def _grads(params):
    from dsm_tpu_torch import train as TR

    out = []
    for p in TR.leaves(params):
        out.append(None if p.grad is None else p.grad.clone())
        p.grad = None
    return out


def phase_train_path(dev, card):
    """``[train-path]``: the loss and its gradient at tts-1.6b's widths cut to
    TRAIN_PATH_LAYERS temporal layers and TRAIN_PATH_SLICES DepFormer slices,
    once through the kernels and once through their plain versions
    (``plain_seams``: the same autograd Function with the plain commit and
    the plain backward): the losses equal, every gradient leaf bit for bit
    but the embedding tables' (index accumulation: relative L2 within
    TRAIN_EMB_REL_L2), both sides' launches counted."""
    import dataclasses

    import torch

    from dsm_tpu_torch import train as TR
    from dsm_tpu_torch.models import lm as LM

    tag = "train-path"
    counters = _train_counters()
    full = _tts16_lm()
    lm_cfg = dataclasses.replace(
        full, transformer=dataclasses.replace(full.transformer, num_layers=TRAIN_PATH_LAYERS),
        depformer=dataclasses.replace(full.depformer, num_slices=TRAIN_PATH_SLICES))
    cfg = TR.TrainConfig(lm=lm_cfg)
    params = LM.init(lm_cfg, torch.Generator(device=dev).manual_seed(3), dtype=torch.float32)
    for p in TR.leaves(params):
        p.requires_grad_(True)
    batch = _train_batch(lm_cfg, dev, 9)
    runs = []
    for plain in (False, True):
        for fn in counters.values():
            fn.launches = 0
        with plain_seams() if plain else contextlib.nullcontext():
            loss, aux = TR.loss_fn(cfg, params, batch)
            loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach(), _grads(params),
                     {name: fn.launches for name, fn in counters.items()}))
    (lk, gk, nk), (lp, gp, npl) = runs
    per = TRAIN_PATH_SLICES * lm_cfg.depformer.transformer.num_layers
    want = {name: 0 for name in counters}
    check(npl == want, f"{tag}: the plain side launched {npl}")
    want["ring_commit"] = want["ring_commit_backward"] = per
    check(nk == want, f"{tag}: the kernels' side launched {nk}, want {want}")
    check(bool(torch.isfinite(lk)) and torch.equal(lk, lp),
          f"{tag}: losses {float(lk)!r} / {float(lp)!r}")
    emb = {id(p) for key in ("text_emb", "audio_embs") for p in
           (params[key], params["depformer"][key])}
    n_exact = n_emb = 0
    worst_emb = 0.0
    for p, a, b in zip(TR.leaves(params), gk, gp):
        check((a is None) == (b is None), f"{tag}: a leaf has a gradient on one side only")
        if a is None:
            continue
        check(bool(torch.isfinite(a).all()), f"{tag}: a gradient is not finite")
        if id(p) in emb:
            n_emb += 1
            worst_emb = max(worst_emb, _rel(a, b))
            n_exact += int(torch.equal(a, b))
        else:
            check(torch.equal(a, b), f"{tag}: a gradient leaf {tuple(p.shape)} differs")
    check(worst_emb <= TRAIN_EMB_REL_L2, f"{tag}: embedding gradients differ by {worst_emb!r}")
    n_leaves = sum(a is not None for a in gk)
    print(f"[{tag}] tts-1.6b widths at {TRAIN_PATH_LAYERS} temporal layers and "
          f"{TRAIN_PATH_SLICES} DepFormer slices, f32, B={TRAIN_BATCH} x {TRAIN_FRAMES}: the "
          f"loss {float(lk)!r} through the kernels and through the plain versions, equal; "
          f"{n_leaves - n_emb} gradient leaves bit for bit, the {n_emb} embedding tables' "
          f"relative L2 at most {worst_emb!r} (bar {TRAIN_EMB_REL_L2}; {n_exact} of them bit "
          f"for bit); launches {nk} through the kernels, none through the plain versions; "
          f"card {card}", flush=True)
    del params, runs
    torch.cuda.empty_cache()
    return nk


# ---------------------------------------------------------------------------
# The device mesh (dsm_tpu_torch/parallel/mesh.py) on the one card
# ---------------------------------------------------------------------------

MESH_STT_B = 64  # [mesh-stt]: configs/config-stt-tpu-serving.toml's stt-1b at this batch
MESH_STEPS = 50  # steps of every [mesh-stt] channel, on each engine
MESH_TICKS = 24  # ticks of [mesh-duplex], on each engine
MESH_TTS_AUDIO = 12  # frames of every [mesh-tts] run past the audio delay
# Steps, ticks or frames of each phase's eager dp x tp engine (host threads and
# host joins, 0.3-4.4 s a step): the reference that the captured dp x tp engine
# is held to bit for bit from the same state.
MESH_EAGER_TICKS = 4
# The captured dp x tp step against the eager one, host ms: at most this share.
MESH_CAPTURED_SHARE = 0.2
MESH_TIMES = {}  # engine -> the captured dp x tp figures of its [mesh-*] phase
# A TTS and a duplex shard's device state: what the eager dp x tp engine
# starts from and is held to.
TTS_SHARD_STATE = ("state", "mimi_state", "_mstate", "_ca", "_frames", "_frame_k")
DUPLEX_SHARD_STATE = ("state", "enc_state", "dec_state", "rng")
# A dp engine's frame against the unmeshed engine's: the shards' products
# run at B/dp rows, so bf16 rounds otherwise (measured 7.5e-4 TTS, 6.8e-3
# duplex, NVIDIA H100 80GB HBM3 700 W); a token drawn otherwise gives ~1.
MESH_FRAME_RTOL = 5e-2
# The dp x tp engines against the dp engine (tokens drawn from the same keys,
# each shard quantising its slice of the activation row at the row-parallel
# products, so a close draw may go the other way): the share of channels,
# sessions or dialogues whose words and frames equal the reference's, and
# the worst frame of those.
MESH_TP_SAME = 0.75
MESH_TP_FRAME_RTOL = 5e-2
# [mesh-stt]'s VAD traces at dp x tp against the dp engine's: each channel's
# relative L2 against its own channel's.
MESH_TP_VAD_RTOL = 0.1
# [mesh-stt]'s text tokens at dp x tp against the dp engine's, pad tokens
# included: the share of (channel, step) tokens that are equal.  Greedy
# tokens of the same inputs; a close pair of logits may go the other way
# once (row-parallel products quantised a slice at a time), and the token
# fed back then moves that channel's later steps: at least MESH_TP_SAME of
# channels equal throughout gives at least this share.
MESH_TP_TOKENS_SAME = 0.75

# The [bench-*] runs are kept short so that the script stays under 900 s (the
# sweep and the longer runs go through ``cli bench``, PERF.md section 6).
BENCH_S = 3.0  # seconds of [bench-stt]'s and [bench-duplex]'s paced runs
BENCH_TTS_S = 2.0  # [bench-tts]: its sessions' launch window (the cohort runs past it)
BENCH_TTS_WORDS = 8  # words a [bench-tts] session
BENCH_DRAIN_S = 20.0  # the cap on [bench-tts]'s and [bench-duplex]'s drains ([bench-stt]: 15 s)


def _mesh(dev, dp, tp):
    """A dp x tp mesh whose every shard is ``dev``: each shard a separate
    engine on the one card."""
    from dsm_tpu_torch.parallel import mesh as PM

    return PM.make_mesh(dp, tp, devices=[dev] * (dp * tp))


def _zeroed(counters):
    for fn in counters.values():
        fn.launches = 0
    return counters


def _launched(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _oversubscribed(mod, tag):
    """The builder's ``[mesh]`` of one shard more than the machine's cards raises."""
    import dataclasses

    import torch

    from dsm_tpu_torch.server import builder

    n = torch.cuda.device_count()
    over = dataclasses.replace(mod, raw=dict(mod.raw, mesh={"dp": n + 1}))
    try:
        builder.build_mesh_from_config(over, "cuda")
    except ValueError as e:
        print(f"[{tag}] the builder's [mesh] dp = {n + 1} on {n} card(s) raises: {e}",
              flush=True)
        return
    check(False, f"{tag}: a mesh of {n + 1} shards on {n} card(s) did not raise")


def _tp_lm_check(tag, lm_cfg, params, state, text, audio, ca=None):
    """One LM step from ``state`` split over two tp shards of the card (the
    tp-local config, each shard's slice of the permuted params, its heads of
    the rings and of the voice store ``ca``, the three joins summed in shard
    order on two host threads) against the unsplit step from the same state,
    through ``_compare_routes``: every ring row but w equal, row w within
    ROW_RTOL, outputs within a bar.  Twice: with the int8 weights as served
    (W8A8: layer 0's rings bit for bit, the integer products being exact;
    each shard quantises its own slice of the activation row at the
    row-parallel products, as the JAX meshed step does, so the split step
    legitimately rounds otherwise: FULL_RING_RTOL) and with the same int8
    weights weight-only (``qmm``, whose K split follows the output width, so
    layer 0's rows round otherwise too; the joins' and the products' sum
    orders differ: PATH_RTOL).  Both sides' launches counted -> the split
    steps'."""
    import dataclasses

    import torch

    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import transformer as T
    from dsm_tpu_torch.parallel import mesh as PM

    dev = text.device
    b, heads = text.shape[0], lm_cfg.transformer.num_heads
    h = heads // 2
    local = dataclasses.replace(
        lm_cfg, transformer=PM.tp_local_transformer_cfg(lm_cfg.transformer, 2))
    counters = {**_lm_counters(), "ca_decode_attend": DA.ca_decode_attend}
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    w = int(state["t"]["pos"]) % state["t"]["valid"].shape[1]
    total = {}
    for what, weights, rtol, exact in (
            ("W8A8, as served", params, FULL_RING_RTOL, True),
            ("weight-only", T.quantize_weights(params, w8a8=False), PATH_RTOL, False)):
        permuted = PM.permute_tp_params({"lm": weights}, 2)
        shards = [[(PM.tp_shard_params(permuted, 2, t)["lm"],
                    _clone(PM.state_shard({"lm": state}, 1, 2, 0, t, b, heads)["lm"]),
                    None if ca is None else {
                        k: v if k == "s_len" else v[:, :, t * h:(t + 1) * h].contiguous()
                        for k, v in ca.items()})
                   for t in range(2)]]
        runner = PM.ShardRunner(_mesh(dev, 1, 2), shards)
        before = _launched(counters)
        outs = runner.run(lambda d, t, sh: LM.step(local, sh[0], sh[1], text, audio, mask,
                                                   ca_kv=sh[2]))[0]
        torch.cuda.synchronize()
        split = {k: n - before[k] for k, n in _launched(counters).items()}
        runner.close()
        (l0, h0, s0), (l1, h1, s1) = outs
        check(torch.equal(l0, l1) and torch.equal(h0, h1),
              f"{tag}: the tp shards' outputs differ ({what})")
        rings = [{key: torch.cat([a[key], c[key]], dim=1) for key in ("k", "v", "ks", "vs")}
                 for a, c in zip(s0["t"]["layers"], s1["t"]["layers"])]
        before = _launched(counters)
        with torch.inference_mode():
            logits, hidden, st = LM.step(lm_cfg, weights, _clone(state), text, audio, mask,
                                         ca_kv=ca)
        torch.cuda.synchronize()
        whole = {k: n - before[k] for k, n in _launched(counters).items()}
        ref_rings = [{key: layer[key] for key in ("k", "v", "ks", "vs")}
                     for layer in st["t"]["layers"]]
        same, row, err = _compare_routes(
            tag, f"the tp = 2 LM step ({what})",
            ({"hidden": h0, "text_logits": l0}, rings, split),
            ({"hidden": hidden, "text_logits": logits}, ref_rings, whole), w, rtol, exact)
        launched = {k: v for k, v in split.items() if v}
        check(all(split[k] == 2 * whole[k] for k in whole), f"{tag}: the split step launched "
              f"{launched}, not twice the unsplit step's {whole} ({what})")
        print(f"[{tag}] one LM step split over tp = 2 shards of the card ({h} of {heads} heads "
              f"each, the joins summed on the host threads), int8 weights {what}, against the "
              f"unsplit step from the same state: relative L2 {err!r} (bar {rtol}); "
              f"{'layer 0' if exact else 'no layer'}'s rings bit for bit (the integer product "
              f"is exact; qmm's K split follows O); every row but w equal; row w bit for bit "
              f"in {same} of {len(rings)} layers, else "
              f"{row} (bar {ROW_RTOL}); launches {launched}, twice the unsplit step's",
              flush=True)
        total = {k: total.get(k, 0) + v for k, v in split.items()}
    return total


def _tp_lockstep(tag, engine, names):
    """Every dp replica's tp shards of ``engine`` hold the same state (its
    attributes ``names``) bit for bit but for their heads of the main LM's
    rings: the replicated DepFormer, codec, sampling and bookkeeping ran in
    lock-step.  -> the leaves compared."""
    import torch

    n = 0

    def walk(a, b, path):
        nonlocal n
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (str(k),))
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (str(i),))
        elif isinstance(a, torch.Tensor):
            if "lm" in path and "layers" in path and path[-1] in ("k", "v", "ks", "vs"):
                return
            check(a.shape == b.shape and torch.equal(a, b),
                  f"{tag}: the tp shards' {'/'.join(path)} differ")
            n += 1

    for row in engine.shards:
        for name in names:
            walk(getattr(row[0], name), getattr(row[1], name), (name,))
    return n


def _shard_leaves(tree, path=()):
    """``(path, tensor)`` of every tensor of a shard's state tree."""
    import torch

    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _shard_leaves(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _shard_leaves(v, path + (str(i),))]
    return [(path, tree)] if isinstance(tree, torch.Tensor) else []


def _tp_copy_state(src, dst, names):
    """``dst``'s shards take ``src``'s device state (its attributes
    ``names``), in place: the eager dp x tp engine starts where the captured
    one's warm-up left it."""
    import torch

    with torch.inference_mode():
        for d, row in enumerate(src.shards):
            for t, sh in enumerate(row):
                for name in names:
                    for (_, a), (_, b) in zip(_shard_leaves(getattr(sh, name)),
                                              _shard_leaves(getattr(dst.shards[d][t], name))):
                        b.copy_(a)
    torch.cuda.synchronize()


def _tp_same_state(tag, got, want, names):
    """Every shard of the captured dp x tp engine ``got`` holds the device
    state (its attributes ``names``) of the same shard of the eager ``want``
    bit for bit -> the leaves compared."""
    import torch

    torch.cuda.synchronize()
    n = 0
    for d, row in enumerate(got.shards):
        for t, sh in enumerate(row):
            for name in names:
                pairs = zip(_shard_leaves(getattr(sh, name)),
                            _shard_leaves(getattr(want.shards[d][t], name)))
                for (path, a), (_, b) in pairs:
                    check(_bits_equal(a, b), f"{tag}: captured tp shard ({d}, {t}) "
                          f"{name}/{'/'.join(path)} differs from the eager engine's")
                    n += 1
    return n


def _tp_capture(tag, engine, counters, per_step, warm_steps=2):
    """``engine.warmup(warm_steps)``: every tp shard of every replica
    captured into its replica's graph (tp shard 0's), the shard threads
    ended, the wrappers' launches only the warm-up's and the capture's ->
    seconds, the joins a step (each a slot copy and tp - 1 adds a shard),
    the launches.  As many warm-up steps as the dp engine's: each advances
    the rings' position, and with it the order the attention sums in, which
    the comparison with the dp engine reads."""
    from dsm_tpu_torch.parallel import mesh as PM

    import torch

    check(engine.cuda_graph, f"{tag}: the dp x tp engine is not captured on the card")
    _zeroed(counters)
    t0 = time.perf_counter()
    engine.warmup(warm_steps)
    seconds = time.perf_counter() - t0
    check(all(isinstance(row[0]._graph, torch.cuda.CUDAGraph) and
              all(isinstance(sh._graph, PM._PeerGraph) for sh in row[1:])
              for row in engine.shards), f"{tag}: a replica is not one graph")
    check(engine._runner._queues is None, f"{tag}: the shard threads outlived the capture")
    n = engine.mesh.dp * engine.mesh.tp
    per = {name: (warm_steps + 1) * n * k for name, k in per_step.items()}
    got = _launched(counters)
    check(got == per, f"{tag}: launches over the tp warm-up and capture {got}, want {per}")
    joins = engine._runner._group._calls[0] / (engine.mesh.dp * (warm_steps + 1))
    _zeroed(counters)
    return seconds, joins, got


def _tp_profile(tag, what, engine, fn, n, per_shard, unit, card):
    """``n`` calls of ``fn`` (one step, tick or frame: a replay of every
    replica's graph) under the profiler -> device launches a ``unit`` a
    shard, kernel ms a ``unit`` (summed over the tp shards' streams, which
    overlap) and the device's busy share (the union of its kernels' spans
    over the wall time, which the profiler stretches; and that union in ms a
    ``unit``).  ``per_shard``: a shard's rope kernels a call (the profile's
    check that it lost no event)."""
    shards = engine.mesh.dp * engine.mesh.tp
    spans = []
    rows, wall_us = _profile(fn, n, rope_launches=n * shards * per_shard, spans=spans)
    kernel_ms = _print_profile(f"{tag}-profile", what, rows, wall_us, n, unit, card, 6)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"launches": sum(c for _, _, c in rows) / n / shards, "kernel_ms": kernel_ms,
            "busy": busy_us / wall_us, "busy_ms": busy_us / n / 1e3}


def _stt_log(sessions):
    return {sid: [(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                                 getattr(w, "start_time", None), getattr(w, "stop_time", None))
                                for w in e.words], list(e.markers), e.prs.tobytes())
                  for e in s["events"]] for sid, s in sessions.items()}


def _mesh_stt_serve(engine, sids, eager=None):
    """Channels ``sids`` opened in order on ``engine`` (seeded; each its own
    pcm, its marker and the silence that flushes it, MESH_STEPS frames in
    all) and served through ``tick`` to their end, every frame answered and
    every marker delivered -> each channel's events (step, words, markers,
    VAD bytes), the host ms a step over the run and each channel's id.
    ``eager``: the eager dp x tp engine, started from ``engine``'s shard
    states, given the same channels and ticked beside ``engine`` for its
    first MESH_EAGER_TICKS steps, its shards' states and the events so far
    held to ``engine``'s bit for bit (then it stops) -> also its host ms a
    step, the leaves compared and the events so far."""
    frame, delay = engine.frame_size, engine.cfg.asr_delay_in_tokens
    seconds = (MESH_STEPS - delay - 1) * frame / 24000.0
    sessions = {}
    for sid in sids:
        _open(engine, sid, seconds, sessions, seed=sid)
    steps0, t0 = engine.step_count, time.perf_counter()
    held, eager_s = None, 0.0
    if eager is not None:
        t_e = time.perf_counter()
        _tp_copy_state(engine, eager, ("state",))
        twins = {}
        for sid in sids:
            _open(eager, sid, seconds, twins, seed=sid)
        t_o = time.perf_counter()
        for _ in range(MESH_EAGER_TICKS):
            engine.tick()
        t1 = time.perf_counter()
        for _ in range(MESH_EAGER_TICKS):
            eager.tick()
        eager_ms = (time.perf_counter() - t1) * 1e3 / MESH_EAGER_TICKS
        check(engine.step_count == eager.step_count == steps0 + MESH_EAGER_TICKS,
              "mesh-stt: the captured and eager dp x tp engines stepped otherwise")
        leaves = _tp_same_state("mesh-stt", engine, eager, ("state",))
        check(_stt_log(sessions) == _stt_log(twins), "mesh-stt: the captured dp x tp "
              "engine's events differ from the eager one's")
        held = (eager_ms, leaves, sum(len(s["events"]) for s in sessions.values()))
        eager.stop()
        eager_s = (t_o - t_e) + (time.perf_counter() - t1)  # the eager engine's part
    _drive(engine, sessions)
    ms = (time.perf_counter() - t0 - eager_s) * 1e3 / max(engine.step_count - steps0, 1)
    cfg = engine.cfg.lm
    _verify(sessions, sids, cfg.extra_heads[0] if cfg.extra_heads else 0)
    log = _stt_log(sessions)
    ids = {sid: s["ch"].channel_id for sid, s in sessions.items()}
    for s in sessions.values():
        engine.close_channel(s["ch"])
    return (log, ms, ids) if held is None else (log, ms, ids, held)


def _mesh_tokens(logs, ids):
    """Each channel's logged text tokens (``SessionLogger`` files under
    ``logs``, written as its channel closed) -> ``{sid: tokens}``."""
    from dsm_tpu_torch.utils.session_log import load_session

    return {sid: load_session(os.path.join(logs, f"dsm-tpu-asr-{cid}.safetensors"))[0]
            for sid, cid in ids.items()}


def _vad(log):
    import numpy as np
    import torch

    return torch.from_numpy(np.stack([np.frombuffer(e[3], np.float32) for e in log]))


def phase_mesh_stt(dev, card):
    """``[mesh-stt]``: configs/config-stt-tpu-serving.toml's stt-1b at B=64 on
    meshes that repeat the card, every engine served through ``open_channel``
    and ``tick`` (the dispatch, the shards' pinned buffers and their merge,
    dispatch-ahead at the file's depth): 64 seeded channels of MESH_STEPS
    frames.  The builder's mesh of more shards than cards raises.  The
    unmeshed engine (captured); dp = 2 (each shard's step its own captured
    graph; the file's int16 wire not taken), its launches counted over
    warm-up, capture and the serve, each channel's events bit for bit those
    of an unmeshed engine of its shard's 32 slots serving that shard's
    channels; dp = 2 x tp = 2 captured (each replica's two tp shards one
    graph, the joins on the card), its launches over warm-up and capture,
    its first MESH_EAGER_TICKS steps beside the eager dp x tp engine (one host
    thread a tp shard, host joins): every shard's state and the events so
    far bit for bit, host ms a step of both; its tp shards' states equal but
    for their LM heads, its channels' words and VAD held to the dp engine's
    (MESH_TP_SAME, MESH_TP_VAD_RTOL; each trace nearer its own channel's
    than any other's) and its logged text tokens, step for step, to the dp
    engine's (MESH_TP_TOKENS_SAME); a profile of its step (device launches a
    shard, busy).  One LM step split over tp held to the unsplit step
    (``_tp_lm_check``).  -> launches of the meshed runs."""
    import dataclasses

    import numpy as np
    import torch

    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.utils.session_log import SessionLogger

    tag = "mesh-stt"
    mod = _serving_module("stt", tag)
    mod = dataclasses.replace(mod, batch_size=MESH_STT_B,
                              raw=dict(mod.raw, batch_size=MESH_STT_B, pcm_wire="f32"))
    print(f"[{tag}] batch_size -> {MESH_STT_B}, pcm_wire -> f32 for the unmeshed reference "
          f"(a meshed engine takes the f32 wire, as the JAX engine does)", flush=True)
    _oversubscribed(mod, tag)
    ref = builder.build_batched_asr(mod, dev)
    ref.warmup()
    cfg, params, b, depth = ref.cfg, ref.params, ref.batch_size, ref.pipeline_depth
    sids = range(b)
    want, ms_ref, _ = _mesh_stt_serve(ref, sids)
    lm_state = _clone(ref.state["lm"])
    del ref
    torch.cuda.empty_cache()
    counters = _zeroed({name: _duplex_counters()[name] for name in PER_STEP})
    logs = {what: tempfile.TemporaryDirectory(prefix=f"chip-smoke-mesh-{what}-")
            for what in ("dp", "tp")}
    e_dp = BatchedAsrEngine(cfg, params, b, device=dev, mesh=_mesh(dev, 2, 1),
                            pipeline_depth=depth, pcm_wire_int16=True,
                            session_logger=SessionLogger(logs["dp"].name,
                                                         flush_every_steps=10 ** 6))
    check(e_dp.cuda_graph and not e_dp._pcm_wire_int16, f"{tag}: dp engine not captured on "
          f"the f32 wire")
    e_dp.warmup()
    check(all(sh._graph is not None for sh, in e_dp.shards), f"{tag}: a dp shard not captured")
    got_dp, ms_dp, ids_dp = _mesh_stt_serve(e_dp, sids)
    dp_launches = _launched(counters)
    per = {name: 3 * 2 * n for name, n in PER_STEP.items()}
    check(dp_launches == per, f"{tag}: dp launches {dp_launches}, want {per} (2 shards x "
          f"warm-up + capture, none on replay)")
    e_dp.stop()
    del e_dp
    torch.cuda.empty_cache()
    for d in range(2):
        one = BatchedAsrEngine(cfg, params, b // 2, device=dev, pipeline_depth=depth)
        one.warmup()
        part = range(d * b // 2, (d + 1) * b // 2)
        alone, _, _ = _mesh_stt_serve(one, part)
        differ = [sid for sid in part if got_dp[sid] != alone[sid]]
        check(not differ, f"{tag}: dp shard {d}: channels {differ} differ from an unmeshed "
              f"engine of its {b // 2} slots")
        del one
        torch.cuda.empty_cache()
    e_tp = BatchedAsrEngine(cfg, params, b, device=dev, mesh=_mesh(dev, 2, 2),
                            pipeline_depth=depth,
                            session_logger=SessionLogger(logs["tp"].name,
                                                         flush_every_steps=10 ** 6))
    capture_s, joins, tp_launches = _tp_capture(tag, e_tp, counters, PER_STEP)
    ring = tuple(e_tp.shards[1][1].state["lm"]["t"]["layers"][0]["k"].shape)
    check(ring == (32, 8, 768, 128), f"{tag}: a tp shard's ring is {ring}")
    e_eager = BatchedAsrEngine(cfg, params, b, device=dev, mesh=_mesh(dev, 2, 2),
                               pipeline_depth=depth, cuda_graph=False)
    got_tp, ms_tp, ids_tp, (ms_eager, held, held_events) = _mesh_stt_serve(e_tp, sids, e_eager)
    eager_launches = _launched(counters)
    per = {name: 4 * MESH_EAGER_TICKS * n for name, n in PER_STEP.items()}
    check(eager_launches == per, f"{tag}: the eager tp engine's launches {eager_launches}, "
          f"want {per} (the captured one launches none on replay)")
    del e_eager
    leaves = _tp_lockstep(tag, e_tp, ("state",))
    pcm = (np.random.default_rng(7).standard_normal((b, 1, e_tp.frame_size)) * 0.1
           ).astype(np.float32)
    on, off = np.ones(b, bool), np.zeros(b, bool)
    prof = _tp_profile(tag, "dp = 2 x tp = 2 captured step, 64 slots: ", e_tp,
                       lambda: e_tp._invoke_step(pcm, on, off), 2,
                       PER_STEP["rope_qk"] + PER_STEP["rope_commit"], "step", card)
    e_tp.stop()
    del e_tp
    torch.cuda.empty_cache()
    tp_launches = {k: tp_launches[k] + eager_launches.get(k, 0) for k in tp_launches}
    tok_dp, tok_tp = _mesh_tokens(logs["dp"].name, ids_dp), _mesh_tokens(logs["tp"].name, ids_tp)
    for d in logs.values():
        d.cleanup()
    check(all(tok_tp[s].shape == tok_dp[s].shape == (len(got_dp[s]),) for s in sids),
          f"{tag}: the session logs do not hold one text token a step")
    tok_same = sum(int((tok_tp[s] == tok_dp[s]).sum()) for s in sids)
    tok_all = sum(tok_dp[s].size for s in sids)
    pad = cfg.text_pad_token
    not_pad = sum(int((tok_dp[s] != pad).sum()) for s in sids)
    kinds = len(set(int(t) for s in sids for t in tok_dp[s]))

    def words(log):
        return [e[1] for e in log]

    same_ref = sum(words(got_dp[s]) == words(want[s]) for s in sids)
    same_tp = sum(words(got_tp[s]) == words(got_dp[s]) for s in sids)
    n_words = sum(len(e[1]) for s in sids for e in got_dp[s])
    vad_ref = max(_rel(_vad(got_dp[s]), _vad(want[s])) for s in sids)
    own = [_rel(_vad(got_tp[s]), _vad(got_dp[s])) for s in sids]
    other = [min(_rel(_vad(got_tp[s]), _vad(got_dp[o])) for o in sids if o != s) for s in sids]
    print(f"[{tag}] stt-1b B={b}, {b} channels of {MESH_STEPS} frames through open_channel and "
          f"tick: dp = 2 (captured, depth {depth}) each channel's events bit for bit an "
          f"unmeshed engine's of its shard's {b // 2} slots; against the unmeshed B={b} engine "
          f"(products at B={b} rows) {same_ref} / {b} channels with its words ({n_words} words "
          f"at dp), worst VAD relative L2 {vad_ref!r}; dp = 2 x tp = 2 captured (each replica "
          f"one graph, captured in {capture_s:.2f} s, {joins:.0f} joins a step) against dp: "
          f"{same_tp} / {b} channels with its words (bar {MESH_TP_SAME}), VAD relative L2 "
          f"worst {max(own)!r} (bar {MESH_TP_VAD_RTOL}), against the nearest other channel "
          f"at least {min(other)!r}; against the eager dp x tp engine over its first "
          f"{MESH_EAGER_TICKS} steps: {held} state leaves of the 4 shards and {held_events} "
          f"events bit for bit; the tp shards' states equal in {leaves} leaves but their LM "
          f"heads; launches over the tp warm-up and capture "
          f"{ {k: v for k, v in tp_launches.items() if v} } with the eager engine's "
          f"{MESH_EAGER_TICKS} steps (none on replay), the dp engine's over warm-up, capture "
          f"and serve { {k: v for k, v in dp_launches.items() if v} }", flush=True)
    print(f"[{tag}] host ms a step over the serve (depth {depth}): unmeshed captured "
          f"{ms_ref!r}, dp = 2 captured {ms_dp!r}, dp = 2 x tp = 2 captured {ms_tp!r}, "
          f"dp = 2 x tp = 2 eager {ms_eager!r} ({MESH_EAGER_TICKS} steps; captured / eager "
          f"{ms_tp / ms_eager!r}, bar {MESH_CAPTURED_SHARE}); the captured dp x tp step: "
          f"{prof['launches']:.0f} device launches a shard ({joins:.0f} joins x 2 of them), "
          f"kernels {prof['kernel_ms']!r} ms summed over the overlapping tp streams, device "
          f"busy {prof['busy']!r} of the profiled wall ({prof['busy_ms']!r} ms); card {card}",
          flush=True)
    MESH_TIMES["stt"] = {"ms": ms_tp, "eager_ms": ms_eager, **prof}
    check(ms_tp <= MESH_CAPTURED_SHARE * ms_eager, f"{tag}: the captured dp x tp step "
          f"{ms_tp!r} ms is over {MESH_CAPTURED_SHARE} of the eager one's {ms_eager!r}")
    print(f"[{tag}] text tokens logged a step (SessionLogger on both engines), pad tokens "
          f"included: dp x tp equal to dp in {tok_same} of {tok_all} (channel, step) tokens "
          f"({tok_same / tok_all!r}, bar {MESH_TP_TOKENS_SAME}); at dp {not_pad} of them not "
          f"the pad token {pad}, {kinds} distinct tokens", flush=True)
    check(same_tp >= MESH_TP_SAME * b, f"{tag}: {same_tp} / {b} tp channels with the dp words")
    check(tok_same >= MESH_TP_TOKENS_SAME * tok_all,
          f"{tag}: {tok_same} / {tok_all} tp text tokens equal to the dp engine's")
    check(max(own) <= MESH_TP_VAD_RTOL, f"{tag}: tp VAD relative L2 {max(own)!r}")
    check(all(a < o for a, o in zip(own, other)), f"{tag}: a tp channel's VAD is nearer "
          f"another channel's than its own")
    g = torch.Generator(device=dev).manual_seed(22)
    text = torch.randint(0, cfg.lm.text_in_vocab_size - 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    audio = torch.randint(0, cfg.lm.audio_vocab_size - 1, (b, cfg.lm.audio_codebooks),
                          generator=g, device=dev, dtype=torch.int32)
    lm_launches = _tp_lm_check(tag, cfg.lm, params["lm"], lm_state, text, audio)
    return {k: dp_launches.get(k, 0) + tp_launches.get(k, 0) + lm_launches.get(k, 0)
            for k in set(dp_launches) | set(lm_launches)}


def _mesh_tts_frames(cfg, fuse, audio):
    """Frames of a [mesh-tts] run: ``audio`` past the first audio (the
    text-audio and acoustic delays), whole dispatches of ``fuse``."""
    frames = cfg.text_audio_delay_in_tokens + cfg.acoustic_delay + audio
    return -(-frames // fuse) * fuse


def _mesh_tts_run(engine, tag, frames, eager=None):
    """16 sessions on ``engine`` (8 with voices), ``frames`` frames, then
    what is in flight -> each session's words and frames; every frame whole
    and finite, some audio.  ``eager``: the eager dp x tp engine, started
    from ``engine``'s shard states, given the same sessions and ticked
    beside ``engine`` for its first
    MESH_EAGER_TICKS frames, its shards' device states (the LM, codec and
    script machine states, the voice store, the dispatch's packed frames)
    held to ``engine``'s bit for bit (then it stops) -> also the eager host
    ms a frame, the leaves compared and the seconds the eager engine took."""
    import numpy as np

    from dsm_tpu_torch.server.tts_module import AudioEvent, WordEvent

    sessions = {}
    for sid in range(16):
        _tts_open(engine, sid, f"spk{sid}" if sid < 8 else None, sessions)
    ticks = frames // engine.fuse
    held = None
    if eager is not None:
        t0 = time.perf_counter()
        _tp_copy_state(engine, eager, TTS_SHARD_STATE)
        twins = {}
        for sid in range(16):
            _tts_open(eager, sid, f"spk{sid}" if sid < 8 else None, twins)
        t_o = time.perf_counter()
        first = MESH_EAGER_TICKS // engine.fuse
        for _ in range(first):
            engine.tick()
        t1 = time.perf_counter()
        for _ in range(first):
            eager.tick()
        eager_ms = (time.perf_counter() - t1) * 1e3 / (first * engine.fuse)
        leaves = _tp_same_state(tag, engine, eager, TTS_SHARD_STATE)
        eager.stop()
        ticks -= first
        held = (eager_ms, leaves, (t_o - t0) + (time.perf_counter() - t1))
    for _ in range(ticks):
        engine.tick()
    engine.stop()
    out = {}
    for sid, sess in sessions.items():
        frames = [e.pcm for e in sess["events"] if isinstance(e, AudioEvent)]
        for pcm in frames:
            check(pcm.shape == (engine.mimi_cfg.frame_size,) and bool(np.isfinite(pcm).all()),
                  f"{tag}: session {sid}: bad frame")
        out[sid] = ([e.text for e in sess["events"] if isinstance(e, WordEvent)], frames)
        engine.close_session(sess["drv"])
    check(sum(len(f) for _, f in out.values()) > 0, f"{tag}: no audio")
    return out if held is None else (out, held)


def _tts_like(ref, dev, mesh, cuda_graph=None):
    from dsm_tpu_torch.server.tts_batched import BatchedTtsEngine

    eng = BatchedTtsEngine(
        ref.cfg, ref.params, ref.mimi_cfg, ref.mimi_params, ref.tokenizer,
        batch_size=ref.batch_size, ca_len=ref.ca_len, cfg_enabled=ref.cfg_enabled,
        ca_quant=ref.ca_quant, device=dev, pcm_wire_int16=ref._pcm_wire_i16,
        fuse_ticks=ref.fuse, script_cap=ref.script_cap, pipeline_depth=ref.pipeline_depth,
        mesh=mesh, cuda_graph=cuda_graph)
    eng.voices = ref.voices
    return eng


def _agreement(got, want, whole=True):
    """The sessions whose words and frames are the reference's (``whole``:
    as many; else as far as ``got`` runs, its words and frames a prefix of
    the reference's), and the worst relative L2 of their frames against
    the reference's."""
    import torch

    same, worst = [], 0.0
    for sid, (words, frames) in want.items():
        g_words, g_frames = got[sid]
        if whole and (g_words != words or len(g_frames) != len(frames)):
            continue
        if g_words != words[:len(g_words)] or len(g_frames) > len(frames):
            continue
        same.append(sid)
        for a, b in zip(g_frames, frames):
            worst = max(worst, _rel(torch.from_numpy(a), torch.from_numpy(b)))
    return same, worst


def phase_mesh_tts(dev, card):
    """``[mesh-tts]``: configs/config-tts-tpu-serving.toml as shipped (tts-1.6b,
    B=64, fuse_ticks 4, depth 2, int8 voice store, int16 wire): 16 sessions
    (8 with seeded voices) through ``open_session`` and ``tick`` for
    MESH_TTS_AUDIO frames past the audio delay (``_mesh_tts_frames``) on the
    unmeshed engine (captured) and on dp = 2 (each shard's frame its own
    captured graph, launches counted over warm-up, capture and the run), all
    16 sessions with the unmeshed engine's words and frames (MESH_FRAME_RTOL);
    then dp = 2 x tp = 2 captured (a replica's tp shards one graph), its
    launches over warm-up and capture, its tp shards' states equal but for
    their LM heads,
    its sessions' words and frames held to the dp engine's (MESH_TP_SAME,
    MESH_TP_FRAME_RTOL), its first MESH_EAGER_TICKS frames beside the eager dp
    x tp engine's (every shard's device state bit for bit), a profile of its
    frame; one LM step with the voice store split over tp held to the
    unsplit step.  -> launches of the meshed runs."""
    import torch

    from dsm_tpu_torch.server import builder

    tag = "mesh-tts"
    mod = _serving_module("tts", tag)
    ref = builder.build_batched_tts(mod, dev)
    _tts_voices(ref)
    ref.warmup()
    n_frames = _mesh_tts_frames(ref.cfg, ref.fuse, MESH_TTS_AUDIO)
    t0 = time.perf_counter()
    want = _mesh_tts_run(ref, tag, n_frames)
    ms_ref = (time.perf_counter() - t0) * 1e3 / n_frames
    lm_state, ca = _clone(ref.state["lm"]), ref._ca
    counters = _zeroed(_tts_counters(PER_TICK_TTS))
    e_dp = _tts_like(ref, dev, _mesh(dev, 2, 1))
    e_dp.warmup()
    check(all(sh._graph is not None for sh, in e_dp.shards), f"{tag}: a dp shard not captured")
    t0 = time.perf_counter()
    got_dp = _mesh_tts_run(e_dp, tag, n_frames)
    ms_dp = (time.perf_counter() - t0) * 1e3 / n_frames
    dp_launches = _launched(counters)
    per = {name: 3 * 2 * n for name, n in PER_TICK_TTS.items()}
    check(dp_launches == per, f"{tag}: dp launches {dp_launches}, want {per} (2 shards x "
          f"warm-up + capture, none on replay)")
    del e_dp
    torch.cuda.empty_cache()
    same_dp, worst_dp = _agreement(got_dp, want)
    check(len(same_dp) == 16, f"{tag}: dp sessions {sorted(set(want) - set(same_dp))} differ "
          f"from the unmeshed engine's words or frame count")
    check(worst_dp <= MESH_FRAME_RTOL, f"{tag}: a dp frame's relative L2 {worst_dp!r}")
    e_tp = _tts_like(ref, dev, _mesh(dev, 2, 2))
    capture_s, joins, tp_launches = _tp_capture(tag, e_tp, counters, PER_TICK_TTS)
    e_eager = _tts_like(ref, dev, _mesh(dev, 2, 2), cuda_graph=False)
    t0 = time.perf_counter()
    got_tp, (ms_eager, held, eager_s) = _mesh_tts_run(e_tp, tag, n_frames, e_eager)
    ms_tp = (time.perf_counter() - t0 - eager_s) * 1e3 / n_frames
    eager_launches = _launched(counters)
    per = {name: 4 * MESH_EAGER_TICKS * n for name, n in PER_TICK_TTS.items()}
    check(eager_launches == per, f"{tag}: the eager tp engine's launches {eager_launches}, "
          f"want {per} (the captured one launches none on replay)")
    del e_eager
    leaves = _tp_lockstep(tag, e_tp, ("state", "mimi_state", "_mstate"))
    # One frame of the fused dispatch: each replica's frame graph replayed once.
    prof = _tp_profile(tag, "dp = 2 x tp = 2 captured frame: ", e_tp,
                       lambda: [row[0]._graph.replay() for row in e_tp.shards], 1,
                       PER_TICK_TTS["rope_qk"] + PER_TICK_TTS["rope_commit"], "frame", card)
    del e_tp
    torch.cuda.empty_cache()
    tp_launches = {k: tp_launches[k] + eager_launches.get(k, 0) for k in tp_launches}
    same_tp, worst_tp = _agreement(got_tp, got_dp)
    print(f"[{tag}] tts-1.6b B={ref.batch_size}, 16 sessions, {n_frames} frames: dp = 2 "
          f"(captured) all 16 with the unmeshed engine's words and frame count, worst frame "
          f"relative L2 {worst_dp!r} (bar {MESH_FRAME_RTOL}); dp = 2 x tp = 2 captured (each "
          f"replica one graph, captured in {capture_s:.2f} s, {joins:.0f} joins a frame; "
          f"{sum(len(f) for _, f in got_tp.values())} audio frames): {len(same_tp)} / 16 "
          f"sessions with the dp engine's words and frames (bar {MESH_TP_SAME}), worst frame "
          f"relative L2 {worst_tp!r} (bar {MESH_TP_FRAME_RTOL}); against the eager dp x tp "
          f"engine over its first {MESH_EAGER_TICKS} frames: {held} state leaves of the 4 "
          f"shards bit for bit; the tp shards' states equal in {leaves} leaves but their LM "
          f"heads; launches over the tp warm-up and capture with the eager engine's frames "
          f"{ {k: v for k, v in tp_launches.items() if v} } (none on replay); host ms a frame "
          f"(the run over its frames, sessions' host work included): unmeshed captured "
          f"{ms_ref!r}, dp = 2 captured {ms_dp!r}, dp = 2 x tp = 2 captured {ms_tp!r}, eager "
          f"{ms_eager!r} (captured / eager {ms_tp / ms_eager!r}, bar {MESH_CAPTURED_SHARE}); "
          f"the captured dp x tp frame: {prof['launches']:.0f} device launches a shard "
          f"({joins:.0f} joins x 2 of them), kernels {prof['kernel_ms']!r} ms summed over the "
          f"overlapping tp streams, device busy {prof['busy']!r} of the profiled wall "
          f"({prof['busy_ms']!r} ms); card {card}", flush=True)
    MESH_TIMES["tts"] = {"ms": ms_tp, "eager_ms": ms_eager, **prof}
    check(len(same_tp) >= MESH_TP_SAME * 16, f"{tag}: {len(same_tp)} / 16 tp sessions agree")
    check(worst_tp <= MESH_TP_FRAME_RTOL, f"{tag}: a tp frame's relative L2 {worst_tp!r}")
    check(ms_tp <= MESH_CAPTURED_SHARE * ms_eager, f"{tag}: the captured dp x tp frame "
          f"{ms_tp!r} ms is over {MESH_CAPTURED_SHARE} of the eager one's {ms_eager!r}")
    b = ref.batch_size
    g = torch.Generator(device=dev).manual_seed(23)
    cfg = ref.cfg
    text = torch.randint(0, cfg.lm.text_in_vocab_size - 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    audio = torch.randint(0, cfg.lm.audio_vocab_size - 1, (b, cfg.lm.audio_codebooks),
                          generator=g, device=dev, dtype=torch.int32)
    lm_launches = _tp_lm_check(tag, cfg.lm, ref.params["lm"], lm_state, text, audio, ca)
    del ref
    torch.cuda.empty_cache()
    return {k: dp_launches.get(k, 0) + tp_launches.get(k, 0) + lm_launches.get(k, 0)
            for k in set(dp_launches) | set(lm_launches)}


def _duplex_events(events):
    import numpy as np

    return {sid: [(type(e).__name__, getattr(e, "text", None),
                   np.asarray(getattr(e, "pcm", np.zeros(0))).tobytes()) for e in evs]
            for sid, evs in events.items()}


def _mesh_duplex_run(engine, tag, ticks, eager=None):
    """16 dialogues on ``engine`` (3 text-only), ``ticks`` ticks of seeded
    pcm, then what is in flight -> each dialogue's text and frames; every
    frame whole and finite, some audio.  ``eager``: the eager dp x tp
    engine, started from ``engine``'s shard states, given the same
    dialogues and ticked beside ``engine`` for its
    first MESH_EAGER_TICKS ticks, its shards' device states (LM, codec
    encoder and decoder, key) and the events so far held to ``engine``'s bit
    for bit (then it stops) -> also the eager host ms a tick, the leaves
    compared and the seconds the eager engine took."""
    import numpy as np

    from dsm_tpu_torch.server.duplex_batched import DuplexAudioEvent, DuplexTextEvent

    frame = engine.mimi_cfg.frame_size

    def open_all(eng):
        events = {}
        for sid in range(16):
            events[sid] = []
            drv = eng.open_session(events[sid].append,
                                   asr_delay_in_tokens=6 if sid in DUPLEX_TEXT_ONLY else 0)
            drv.push_pcm(_pcm(sid, ticks * frame / 24000.0, frame))
        return events

    events = open_all(engine)
    held = None
    if eager is not None:
        t0 = time.perf_counter()
        _tp_copy_state(engine, eager, DUPLEX_SHARD_STATE)
        twins = open_all(eager)
        t_o = time.perf_counter()
        for _ in range(MESH_EAGER_TICKS):
            engine.tick()
        t1 = time.perf_counter()
        for _ in range(MESH_EAGER_TICKS):
            eager.tick()
        eager_ms = (time.perf_counter() - t1) * 1e3 / MESH_EAGER_TICKS
        leaves = _tp_same_state(tag, engine, eager, DUPLEX_SHARD_STATE)
        check(_duplex_events(events) == _duplex_events(twins), f"{tag}: the captured dp x tp "
              f"engine's events differ from the eager one's")
        eager.stop()
        held = (eager_ms, leaves, (t_o - t0) + (time.perf_counter() - t1))
        ticks -= MESH_EAGER_TICKS
    for _ in range(ticks):
        engine.tick()
    engine.stop()
    out = {}
    for sid, evs in events.items():
        frames = [e.pcm for e in evs if isinstance(e, DuplexAudioEvent)]
        for pcm in frames:
            check(pcm.shape == (frame,) and bool(np.isfinite(pcm).all()),
                  f"{tag}: dialogue {sid}: bad frame")
        out[sid] = ([e.text for e in evs if isinstance(e, DuplexTextEvent)], frames)
    check(sum(len(f) for _, f in out.values()) > 0, f"{tag}: no audio")
    return out if held is None else (out, held)


def phase_mesh_duplex(dev, card):
    """``[mesh-duplex]``: configs/config-duplex-tpu-serving.toml as shipped
    (s2s-2b, B=24, depth 2): 16 dialogues (3 text-only) through
    ``open_session`` and ``tick`` for MESH_TICKS ticks on the unmeshed engine
    (captured), on dp = 2 (each shard's tick its own captured graph; all 16
    dialogues with the unmeshed engine's text and frames, MESH_FRAME_RTOL)
    and on dp = 2 x tp = 2 captured (a replica's tp shards one graph;
    launches over warm-up and capture, its first MESH_EAGER_TICKS ticks
    beside the eager dp x tp engine's, every shard's state and the events so
    far bit for bit; its tp shards' states equal but for their LM heads, its
    dialogues held to the dp engine's: MESH_TP_SAME, MESH_TP_FRAME_RTOL; a
    profile of its tick); one LM step split over tp held to the unsplit
    step.  -> launches of the meshed runs."""
    import numpy as np
    import torch

    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server.duplex_batched import BatchedDuplexEngine

    tag = "mesh-duplex"
    ref = builder.build_duplex(_duplex_module(tag, 8, 2), dev)
    ref.warmup()
    t0 = time.perf_counter()
    want = _mesh_duplex_run(ref, tag, MESH_TICKS)
    ms_ref = (time.perf_counter() - t0) * 1e3 / MESH_TICKS
    lm_state = _clone(ref.state["lm"])

    def like(mesh, cuda_graph=None):
        return BatchedDuplexEngine(ref.cfg, ref.params, ref.mimi_cfg, ref.mimi_params,
                                   ref.tokenizer, batch_size=ref.batch_size,
                                   kv_quant=ref.kv_quant, kv_bits=ref.kv_bits, device=dev,
                                   pipeline_depth=ref.pipeline_depth, mesh=mesh,
                                   cuda_graph=cuda_graph)

    counters = _zeroed({name: _duplex_counters()[name] for name in PER_TICK_DUPLEX})
    e_dp = like(_mesh(dev, 2, 1))
    e_dp.warmup()
    check(all(sh._graph is not None for sh, in e_dp.shards), f"{tag}: a dp shard not captured")
    t0 = time.perf_counter()
    got_dp = _mesh_duplex_run(e_dp, tag, MESH_TICKS)
    ms_dp = (time.perf_counter() - t0) * 1e3 / MESH_TICKS
    dp_launches = _launched(counters)
    per = {name: 3 * 2 * n for name, n in PER_TICK_DUPLEX.items()}
    check(dp_launches == per, f"{tag}: dp launches {dp_launches}, want {per} (2 shards x "
          f"warm-up + capture, none on replay)")
    del e_dp
    torch.cuda.empty_cache()
    same_dp, worst_dp = _agreement(got_dp, want)
    check(len(same_dp) == 16, f"{tag}: dp dialogues {sorted(set(want) - set(same_dp))} differ "
          f"from the unmeshed engine's text or frame count")
    check(worst_dp <= MESH_FRAME_RTOL, f"{tag}: a dp frame's relative L2 {worst_dp!r}")
    e_tp = like(_mesh(dev, 2, 2))
    capture_s, joins, tp_launches = _tp_capture(tag, e_tp, counters, PER_TICK_DUPLEX)
    e_eager = like(_mesh(dev, 2, 2), cuda_graph=False)
    t0 = time.perf_counter()
    got_tp, (ms_eager, held, eager_s) = _mesh_duplex_run(e_tp, tag, MESH_TICKS, e_eager)
    ms_tp = (time.perf_counter() - t0 - eager_s) * 1e3 / MESH_TICKS
    eager_launches = _launched(counters)
    per = {name: 4 * MESH_EAGER_TICKS * n for name, n in PER_TICK_DUPLEX.items()}
    check(eager_launches == per, f"{tag}: the eager tp engine's launches {eager_launches}, "
          f"want {per} (the captured one launches none on replay)")
    del e_eager
    leaves = _tp_lockstep(tag, e_tp, ("state", "enc_state", "dec_state"))
    b = ref.batch_size
    pcm = np.stack([_pcm(s, 0.08, ref.mimi_cfg.frame_size) for s in range(b)])[:, None, :]
    on, off = np.ones(b, bool), np.zeros(b, bool)
    delay = np.zeros(b, np.int32)
    prof = _tp_profile(tag, "dp = 2 x tp = 2 captured tick, 24 slots: ", e_tp,
                       lambda: e_tp._invoke_step(pcm, on, off, delay), 1,
                       PER_TICK_DUPLEX["rope_qk"] + PER_TICK_DUPLEX["rope_commit"], "tick",
                       card)
    del e_tp
    torch.cuda.empty_cache()
    tp_launches = {k: tp_launches[k] + eager_launches.get(k, 0) for k in tp_launches}
    same_tp, worst_tp = _agreement(got_tp, got_dp)
    print(f"[{tag}] s2s-2b B={ref.batch_size}, 16 dialogues, {MESH_TICKS} ticks: dp = 2 "
          f"(captured) all 16 with the unmeshed engine's text and frame count, worst frame "
          f"relative L2 {worst_dp!r} (bar {MESH_FRAME_RTOL}); dp = 2 x tp = 2 captured (each "
          f"replica one graph, captured in {capture_s:.2f} s, {joins:.0f} joins a tick) "
          f"against dp: {len(same_tp)} / 16 (bar {MESH_TP_SAME}), worst frame relative L2 "
          f"{worst_tp!r} (bar {MESH_TP_FRAME_RTOL}); against the eager dp x tp engine over its "
          f"first {MESH_EAGER_TICKS} ticks: {held} state leaves of the 4 shards and the events "
          f"so far bit for bit; the tp shards' states equal in {leaves} leaves but their LM "
          f"heads; launches over the tp warm-up and capture with the eager engine's ticks "
          f"{ {k: v for k, v in tp_launches.items() if v} } (none on replay); host ms a tick "
          f"(the run over its ticks): unmeshed captured {ms_ref!r}, dp = 2 captured "
          f"{ms_dp!r}, dp = 2 x tp = 2 captured {ms_tp!r}, eager {ms_eager!r} (captured / "
          f"eager {ms_tp / ms_eager!r}, bar {MESH_CAPTURED_SHARE}); the captured dp x tp tick: "
          f"{prof['launches']:.0f} device launches a shard ({joins:.0f} joins x 2 of them), "
          f"kernels {prof['kernel_ms']!r} ms summed over the overlapping tp streams, device "
          f"busy {prof['busy']!r} of the profiled wall ({prof['busy_ms']!r} ms); card {card}",
          flush=True)
    MESH_TIMES["duplex"] = {"ms": ms_tp, "eager_ms": ms_eager, **prof}
    check(len(same_tp) >= MESH_TP_SAME * 16, f"{tag}: {len(same_tp)} / 16 tp dialogues agree")
    check(worst_tp <= MESH_TP_FRAME_RTOL, f"{tag}: a tp frame's relative L2 {worst_tp!r}")
    check(ms_tp <= MESH_CAPTURED_SHARE * ms_eager, f"{tag}: the captured dp x tp tick "
          f"{ms_tp!r} ms is over {MESH_CAPTURED_SHARE} of the eager one's {ms_eager!r}")
    b, cfg = ref.batch_size, ref.cfg
    g = torch.Generator(device=dev).manual_seed(24)
    text = torch.randint(0, cfg.lm.text_in_vocab_size - 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    audio = torch.randint(0, cfg.lm.audio_vocab_size - 1, (b, cfg.lm.audio_codebooks),
                          generator=g, device=dev, dtype=torch.int32)
    lm_launches = _tp_lm_check(tag, cfg.lm, ref.params["lm"], lm_state, text, audio)
    del ref
    torch.cuda.empty_cache()
    return {k: dp_launches.get(k, 0) + tp_launches.get(k, 0) + lm_launches.get(k, 0)
            for k in set(dp_launches) | set(lm_launches)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dsm_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    elapsed("start")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.lib()
    print(f"[build] {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    elapsed("build")
    phase_opus(card)
    elapsed("opus")

    errs = phase_kernels(dev)
    elapsed("kernels")
    engine, launches = phase_serve(dev)
    stt1b_numbers = phase_times(engine, dev, card, full_rings=True)
    elapsed("serve + times")
    cfg1b, params1b, batch1b = engine.cfg, engine.params, engine.batch_size
    del engine  # its state goes before the graph phase's engines allocate theirs
    torch.cuda.empty_cache()
    graph = {"stt1b": phase_graph(cfg1b, params1b, batch1b, card, "graph-stt1b", PER_STEP,
                                  serve=True)}
    del params1b
    elapsed("graph-stt1b")
    torch.cuda.empty_cache()
    kv4_launches = phase_stt1b_kv4(dev, card, stt1b_numbers)
    elapsed("stt1b-kv4")
    torch.cuda.empty_cache()
    split_launches = phase_stt1b_split(dev)
    elapsed("stt1b-split")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stt26_engine, stt26_launches = phase_stt26(dev)
    phase_times(stt26_engine, dev, card, tag="stt26-")
    fused_launches = phase_stt26_path(stt26_engine, dev)
    elapsed("stt26")
    stt26_kv4_launches = phase_stt26_kv4(stt26_engine, dev, card)
    elapsed("stt26-kv4")
    cfg26, params26, batch26 = stt26_engine.cfg, stt26_engine.params, stt26_engine.batch_size
    del stt26_engine
    torch.cuda.empty_cache()
    graph["stt26"] = phase_graph(cfg26, params26, batch26, card, "graph-stt26", PER_STEP_STT26)
    del params26
    elapsed("graph-stt26")
    torch.cuda.empty_cache()
    tts_engine, tts_launches, tts_log = phase_tts(dev, card)
    phase_tts_times(tts_engine, dev, card)
    elapsed("tts")
    del tts_engine
    torch.cuda.empty_cache()  # the peak below: the captured engine's, not this one's cache
    graph["tts"] = phase_graph_tts(dev, card, tts_log)
    elapsed("graph-tts")
    tts202501_engine, tts202501_launches, tts202501_log = phase_tts(dev, card,
                                                                    preset="tts_202501")
    phase_tts_times(tts202501_engine, dev, card, tag="tts202501")
    elapsed("tts202501")
    del tts202501_engine
    torch.cuda.empty_cache()
    graph["tts202501"] = phase_graph_tts(dev, card, tts202501_log, preset="tts_202501")
    elapsed("graph-tts202501")
    duplex_engine, duplex_launches, duplex_log = phase_duplex(dev, card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    int8_peak = phase_duplex_times(duplex_engine, dev, card)
    elapsed("duplex")
    del duplex_engine
    torch.cuda.empty_cache()
    graph["duplex"] = phase_graph_duplex(dev, card, duplex_log)
    elapsed("graph-duplex")
    duplex_engine, duplex_kv4_launches, _ = phase_duplex(dev, card, kv_bits=4)
    int4_peak = phase_duplex_times(duplex_engine, dev, card, tag="duplex-kv4", brief=True)
    del duplex_engine
    torch.cuda.empty_cache()
    print(f"[duplex-kv4] int4 rings beside int8 rings (this run, the same card): peak memory "
          f"{int4_peak:.2f} GB against {int8_peak:.2f} GB; card {card}", flush=True)
    elapsed("duplex-kv4")
    phase_graph_duplex_kv4(dev)
    elapsed("graph-duplex-kv4")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-moshi-") as tmp:
        moshi, moshi_launches = phase_moshi_duplex(dev, card, tmp)
        elapsed("moshi-duplex")
        gen, gen_launches = phase_gen(dev, card, tmp)
        elapsed("gen")
    legacy, legacy_launches = phase_tts_legacy(dev, card)
    elapsed("tts-legacy")
    stt_serving = phase_stt_serving(dev, card)
    elapsed("graph-stt-serving")
    tts_serving = phase_tts_serving(dev, card)
    elapsed("graph-tts-serving")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as tmp:
        ckpt_files = phase_ckpt(dev, card, tmp)
        elapsed("ckpt")
        tts_single = phase_tts_single(dev, card, tmp, ckpt_files)
        elapsed("tts-single")
        rooms = phase_mimi_rooms(dev, card, tmp)
        elapsed("mimi-rooms")
        offline, offline_launches = phase_offline(dev, card, tmp)
        elapsed("offline")
    tune_launches = phase_tune(dev)
    elapsed("tune")
    train, train_launches = phase_train(dev, card)
    elapsed("train")
    train_path_launches = phase_train_path(dev, card)
    elapsed("train-path")
    mesh_stt = phase_mesh_stt(dev, card)
    elapsed("mesh-stt")
    mesh_tts = phase_mesh_tts(dev, card)
    elapsed("mesh-tts")
    mesh_duplex = phase_mesh_duplex(dev, card)
    elapsed("mesh-duplex")
    ms = kernel_times(dev, card)
    elapsed("times")
    # ``launches``: the main paths' runs (each counted from 0 to its end) and
    # the two single-step legs; each path's count beside it.  A route's entry
    # counts the path that launches its wrapper at that shape.
    per_path = {"stt": launches, "stt_graph": graph["stt1b"]["launches"],
                "tts": tts_launches, "duplex": duplex_launches,
                "stt26": stt26_launches, "stt26_fused": fused_launches,
                "stt1b_split": split_launches, "stt1b_kv4": kv4_launches,
                "stt26_kv4": stt26_kv4_launches, "duplex_kv4": duplex_kv4_launches,
                "tts202501": tts202501_launches, "tune": tune_launches,
                "tts_graph": graph["tts"]["launches"],
                "tts202501_graph": graph["tts202501"]["launches"],
                "duplex_graph": graph["duplex"]["launches"],
                "stt_serving": stt_serving["launches"], "tts_serving": tts_serving["launches"],
                "tts_single": tts_single["launches"], "mimi_rooms": rooms["launches"],
                "moshi_duplex": moshi_launches, "gen": gen_launches,
                "tts_legacy": legacy_launches, "offline": offline_launches,
                "train": train_launches, "train_path": train_path_launches,
                "mesh_stt": mesh_stt, "mesh_tts": mesh_tts, "mesh_duplex": mesh_duplex}

    def max_err(name, tag=""):
        return max(e for (n, label), e in errs.items() if n == name and label.startswith(tag))

    def route_tag(label):  # a ring's cases share their first word; a voice source is one case
        return label if label.startswith("B=") else label.split()[0] + " "

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": sum(p.get(name, 0) for p in per_path.values()),
                **{f"launches_{path}": p.get(name, 0) for path, p in per_path.items()},
                "max_abs_err": max_err(name), **ms[name],
                "mesh_cases": {label: e for (n, label), e in errs.items()
                               if n == name and label.startswith("mesh")}}
               for name in SOURCES]
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[wrapper], "replaces": tpu,
                 "launches": per_path[path].get(wrapper, 0), "path": path,
                 "case": HEADLINE[name],
                 "max_abs_err": max_err(wrapper, route_tag(HEADLINE[name])), **ms[name]}
                for name, (wrapper, tpu, path) in ROUTES.items()]
    for k in kernels:
        if k["name"] == "ca_decode_attend":  # every shape's cluster size, time and share
            k["shapes"] = CA_TIMES
        if k["name"] in OFF_PATH:
            check(k["launches"] == 0, f"{k['name']} still launched on a path")
            k["path"] = f"none: the step launches {OFF_PATH[k['name']]} in its place"
        else:
            check(k["launches"] > 0, f"{k['name']} was launched on no main path")
    for key, (what, launches, ms) in PARENT_PROFILE.items():
        got_ms, got_launches = PROFILES[key, ""] if key != "duplex-profile" else PROFILES[
            key, "24 slots, short rings: "]
        print(f"[launches] {what}: {got_launches:.0f} device launches, kernels {got_ms!r} ms "
              f"(profiler; before the rope-and-commit kernels, PERF.md section 5: "
              f"{launches} launches, {ms} ms); card {card}", flush=True)
    for key, what in (("stt1b", "stt-1b engine step"), ("stt26", "stt-2.6b engine step"),
                      ("tts", "tts-1.6b engine tick"), ("tts202501", "tts_202501 engine tick")):
        g = graph[key]["graph"]
        print(f"[graph] {what}, captured (this run; the eager step's times are PERF.md "
              f"section 5's): host ms median {g['step_ms']!r} (min {g['min_ms']!r}, max "
              f"{g['max_ms']!r}); device busy {g['busy']!r}; {g['launches']:.0f} device "
              f"launches; kernels {g['kernel_ms']!r} ms; peak memory {g['peak_gb']:.2f} GB "
              f"reserved; card {card}", flush=True)
    g1, g2 = graph["duplex"]["graph"], graph["duplex"]["graph2"]
    print(f"[graph] s2s-2b duplex engine tick, captured at depth 1 and 2 (this run): host ms "
          f"median {g1['step_ms']!r} / {g2['step_ms']!r} (min {g1['min_ms']!r} / "
          f"{g2['min_ms']!r}, max {g1['max_ms']!r} / {g2['max_ms']!r}); "
          f"completion-to-completion {g1['dt_ms']!r} / {g2['dt_ms']!r} ms; at depth 1 device "
          f"busy {g1['busy']!r}, {g1['launches']:.0f} device launches, kernels "
          f"{g1['kernel_ms']!r} ms; peak memory {g1['peak_gb']:.2f} GB reserved; card {card}",
          flush=True)
    ts = tts_single
    print(f"[tts-single] tts-1.6b single session, configs/config-tts.toml (B=1, captured): "
          f"tick host ms median {ts['tick_ms'][0]!r} (min {ts['tick_ms'][1]!r}, max "
          f"{ts['tick_ms'][2]!r}), eager {ts['eager_ms'][0]!r}; {ts['device_launches']:.0f} "
          f"device launches and {ts['kernel_ms']!r} kernel ms a tick; card {card}", flush=True)
    print(f"[mimi-rooms] Mimi v0_1 rooms (B=1 a room, eager, bf16): host ms a frame median "
          f"{rooms['frame_ms'][0]!r}, max {rooms['frame_ms'][1]!r}; 8 rope_commit launches a "
          f"frame; card {card}", flush=True)
    st, tt = stt_serving, tts_serving
    print(f"[serving] stt-1b, configs/config-stt-tpu-serving.toml as shipped (B=192, depth 2, "
          f"int16 wire, captured): tick host ms {st['tick_ms']!r} at depth 2 / "
          f"{st['tick_ms_depth1']!r} at depth 1, completion-to-completion {st['dt_ms']!r} / "
          f"{st['dt_ms_depth1']!r} ms; synchronous step {st['step']['step_ms']!r} ms, kernels "
          f"{st['step']['kernel_ms']!r} ms, {st['step']['launches']:.0f} device launches, "
          f"device busy {st['step']['busy']!r}; peak {st['peak_gb']:.2f} GB reserved; "
          f"auto_batch_size fits B={st['fit']}; tick max {st['gc']['frozen']['max_ms']!r} ms "
          f"and {st['gc']['frozen']['over_80']} ticks over 80 ms with the GC frozen after "
          f"warm-up, {st['gc']['not_frozen']['max_ms']!r} ms and "
          f"{st['gc']['not_frozen']['over_80']} without; card {card}", flush=True)
    print(f"[serving] tts-1.6b, configs/config-tts-tpu-serving.toml as shipped (B=64, "
          f"fuse_ticks 4, depth 2, ca_int8, int16 wire, captured): dispatch host ms "
          f"{tt['tick_ms']!r} ({tt['tick_ms'] / 4!r} a frame), completion-to-completion "
          f"{tt['dt_ms']!r} ms, kernels {tt['kernel_ms']!r} ms and {tt['device_launches']:.0f} device "
          f"launches a dispatch, device busy {tt['busy']!r}; first audio at "
          f"{tt['first_audio'][1]} frames dispatched against {tt['first_audio'][0]} "
          f"single-tick; 52-op apply_ops {tt['ops_ms']!r} ms; peak {tt['peak_gb']:.2f} GB "
          f"reserved; card {card}", flush=True)
    mg = moshi["graph"]
    print(f"[moshi-duplex] Moshi 7B (moshi_v0_1_streaming(8), build_duplex's default), B=24, "
          f"captured at depth 2: tick host ms median {mg['step_ms']!r} (max {mg['max_ms']!r}), "
          f"completion-to-completion {mg['dt_ms']!r} ms; at depth 1 device busy {mg['busy']!r}, "
          f"{mg['launches']:.0f} device launches, kernels {mg['kernel_ms']!r} ms a tick; peak "
          f"memory {mg['peak_gb']:.2f} GB reserved; auto_batch_size fits B={moshi['fit']}; the "
          f"single dialogue (B=1, eager) {moshi['single_ms'][0]!r} ms a frame; card {card}",
          flush=True)
    print(f"[gen] cli gen's path, moshi_v0_1_streaming() B=1 bf16: {gen['ms'][0]!r} ms a step at "
          f"chunk 1, {gen['ms'][1]!r} at chunk {GEN_CHUNK}; [tts-legacy] tts_v0_1 with guidance: "
          f"{legacy['ms']!r} ms a step; [offline] stt-1b transcribe_files realtime factor "
          f"{offline['rtf']!r}x; card {card}", flush=True)
    print(f"[train] tts-1.6b at full width, f32, B={TRAIN_BATCH} x {TRAIN_FRAMES} frames: "
          f"{train['ms']!r} ms a step (median of {TRAIN_STEPS}; loss and backward "
          f"{train['halves'][0]!r}, optimizer {train['halves'][1]!r}; kernels "
          f"{train['kernel_ms']!r} ms), {train['params']:,} parameters, peak "
          f"{train['peak_gb']:.2f} GB reserved; card {card}", flush=True)
    units = {"stt": "stt-1b B=64 step", "tts": "tts-1.6b frame", "duplex": "s2s-2b tick"}
    print("[mesh] dp = 2 x tp = 2 on one card, captured against eager (this run): " + "; ".join(
        f"{units[k]} {m['ms']!r} / {m['eager_ms']!r} host ms, {m['launches']:.0f} device "
        f"launches a shard, busy {m['busy']!r}" for k, m in MESH_TIMES.items())
        + f"; card {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
