#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (dsm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout.  It needs a CUDA device and nvcc; without a
device it exits with code 2 and prints no result.  Phases, one or more
lines each:

1. card: name, power limit, TF32 switches (both off; RVQ distances in f32);
2. build: the CUDA kernels from dsm_tpu_torch/csrc, with nvcc;
3. kernels: each CUDA kernel against its plain PyTorch version at the
   serving path's shapes (commits bit-exact, attention within 2e-2);
4. serve: the BatchedAsr engine from configs/config-stt.toml (stt-1b,
   d=2048, 16 layers, 32 codebooks, B=64, int8 KV, int8 weights + W8A8,
   bf16 codec, seeded random weights) serves 8 sessions, then 4 more in
   reused slots; every frame gets its step event, every marker arrives,
   VAD probabilities are finite, and the kernels launched exactly
   16 scale_commit + 16 decode_attend_commit + 8 ring_commit per step;
5. times: engine step with all 64 slots active, and each kernel against
   its plain version, with CUDA events.

The last three lines: the kernels' JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "dsm_tpu_torch/csrc/ring_attn.cu"
REPLACES = {
    "scale_commit": "dsm_tpu/ops/ring_kernels.py:160",
    "decode_attend_commit": "dsm_tpu/ops/decode_attn.py:545",
    "ring_commit": "dsm_tpu/ops/ring_kernels.py:120",
}
PER_STEP = {"scale_commit": 16, "decode_attend_commit": 16, "ring_commit": 8}
ATOL = RTOL = 2e-2


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(dev):
    """Inputs at the serving path's shapes, from a seeded generator; each
    case is (name, label, run_kernel, run_plain, compare)."""
    import torch

    from dsm_tpu_torch.ops import attention as A
    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import ring_kernels as RK

    g = torch.Generator(device=dev).manual_seed(1234)
    cases = []

    ks = torch.rand(64, 16, 768, generator=g, device=dev)
    vs = torch.rand(64, 16, 768, generator=g, device=dev)
    ksn = torch.rand(64, 16, 1, generator=g, device=dev)
    vsn = torch.rand(64, 16, 1, generator=g, device=dev)
    for w in (0, 5, 767):
        rk, rv, pk, pv = ks.clone(), vs.clone(), ks.clone(), vs.clone()
        cases.append(("scale_commit", f"w={w}",
                      lambda rk=rk, rv=rv, w=w: RK.scale_commit(rk, rv, ksn, vsn, w),
                      lambda pk=pk, pv=pv, w=w: RK.scale_commit_plain(pk, pv, ksn, vsn, w),
                      lambda rk=rk, rv=rv, pk=pk, pv=pv: _exact([rk, rv], [pk, pv])))

    kc = torch.randn(64, 8, 256, 64, generator=g, device=dev).bfloat16()
    vc = torch.randn(64, 8, 256, 64, generator=g, device=dev).bfloat16()
    kn = torch.randn(64, 8, 2, 64, generator=g, device=dev).bfloat16()
    vn = torch.randn(64, 8, 2, 64, generator=g, device=dev).bfloat16()
    for w in (0, 40, 254):
        rk, rv, pk, pv = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        cases.append(("ring_commit", f"w={w}",
                      lambda rk=rk, rv=rv, w=w: RK.ring_commit(rk, rv, kn, vn, w),
                      lambda pk=pk, pv=pv, w=w: RK.ring_commit_plain(pk, pv, kn, vn, w),
                      lambda rk=rk, rv=rv, pk=pk, pv=pv: _exact([rk, rv], [pk, pv])))

    b, h, c, dh, window = 64, 16, 768, 128, 750
    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    k_new = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    v_new = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    kring = torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev, dtype=torch.int8)
    vring = torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev, dtype=torch.int8)
    kscale = torch.rand(b, h, c, generator=g, device=dev) * 0.019 + 0.001
    vscale = torch.rand(b, h, c, generator=g, device=dev) * 0.019 + 0.001
    kq, vq, _, _ = A.quantize_kv_rows(k_new, v_new)
    rows = [x[:, :, 0].contiguous() for x in (q, kq, vq, k_new, v_new)]
    for pos, frac in ((0, 1.0), (40, 0.9), (767, 0.6), (3000, 1.0)):
        valid = torch.rand(b, c, generator=g, device=dev) < frac
        plan = A.global_ring_plan(pos, c, 1, device=dev)
        rk, rv, pk, pv = kring.clone(), vring.clone(), kring.clone(), vring.clone()
        outs = {}

        def run_k(rk=rk, rv=rv, plan=plan, valid=valid, outs=outs):
            outs["k"] = DA.decode_attend_commit(
                q, rk, rv, kscale, vscale, kq, vq, k_new, v_new, plan, valid,
                window=window)[0][:, :, 0]

        def run_p(pk=pk, pv=pv, plan=plan, valid=valid, outs=outs, pos=pos):
            outs["p"] = DA.decode_attend_commit_plain(
                rows[0], pk, pv, kscale, vscale, rows[1], rows[2], rows[3],
                rows[4], valid, pos, plan["w"][0], window)

        def cmp(rk=rk, rv=rv, pk=pk, pv=pv, outs=outs):
            ring_err = _exact([rk, rv], [pk, pv])
            a, p = outs["k"].float(), outs["p"].float()
            check(bool(torch.isfinite(a).all()), "decode_attend_commit output not finite")
            ok = bool(((a - p).abs() <= ATOL + RTOL * p.abs()).all())
            check(ok, "decode_attend_commit output outside 2e-2 of its plain version")
            return max(ring_err, float((a - p).abs().max()))

        cases.append(("decode_attend_commit", f"pos={pos} valid={frac}", run_k, run_p, cmp))
    return cases


def _exact(got, want) -> float:
    import torch

    for a, b in zip(got, want):
        check(torch.equal(a, b), "kernel ring differs from its plain version")
    return 0.0


def phase_kernels(dev):
    import torch

    errs = {}
    for name, label, run_k, run_p, cmp in kernel_cases(dev):
        run_k()
        run_p()
        torch.cuda.synchronize()
        err = cmp()
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"[kernels] {name} {label}: max_abs_err {err!r} (bar: rings exact, "
              f"output atol=rtol={ATOL})", flush=True)
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


def _open(engine, sid, seconds, sessions):
    import numpy as np

    events = []
    ch = engine.open_channel(events.append)
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
            check(e.prs is not None and e.prs.shape == (n_vad,)
                  and bool(np.isfinite(e.prs).all()), f"session {sid}: bad prs")


def phase_serve(dev):
    import torch

    from dsm_tpu_torch.ops import decode_attn as DA
    from dsm_tpu_torch.ops import ring_kernels as RK
    from dsm_tpu_torch.server import builder
    from dsm_tpu_torch.server import config as CFG

    counters = {"scale_commit": RK.scale_commit,
                "decode_attend_commit": DA.decode_attend_commit,
                "ring_commit": RK.ring_commit}
    mod = CFG.Config.load(os.path.join(ROOT, "configs", "config-stt.toml")).modules["asr"]
    t0 = time.perf_counter()
    engine = builder.build_batched_asr(mod, dev)
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

    for fn in counters.values():
        fn.launches = 0
    steps0 = engine.step_count
    n_vad = engine.cfg.lm.extra_heads[0]
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
        check(n > 0, f"{name} never launched on the main path")
        check(n == PER_STEP[name] * steps,
              f"{name}: {n} launches over {steps} steps, want {PER_STEP[name]} per step")
    frames = sum(s["frames"] for s in sessions.values())
    print(f"[serve] 12 sessions, {frames} frames, 12 markers delivered, {steps} "
          f"engine steps; launches {launches} = per step {PER_STEP}", flush=True)
    return engine, launches


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


def phase_times(engine, dev, card):
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
    step_ms = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[times] engine step, 64 slots active: median {step_ms!r} ms, "
          f"min {min(times)!r}, max {max(times)!r} over 50 after 5 warm-up; "
          f"peak memory {peak_gb:.2f} GB; card {card}", flush=True)

    # Where the device time goes: kernel time by name over 5 steps, and the
    # device's busy share of the host's wall time for those steps.
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            engine._invoke_step(pcm, on, off)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    total = sum(t for _, t in rows)
    print(f"[profile] kernels {total / 5e3!r} ms/step of {wall_us / 5e3!r} ms/step wall "
          f"(profiled): device busy {total / wall_us!r}, {len(rows)} kernel names; "
          f"card {card}", flush=True)
    for key, t in rows[:12]:
        print(f"[profile] {t / 5e3:9.4f} ms/step {100 * t / max(total, 1):5.1f}%  {key[:100]}",
              flush=True)

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
        print(f"[times] {name}, 64 slots: median {statistics.median(ts)!r} ms over 20 "
              f"after 5 warm-up; card {card}", flush=True)

    ms = {}
    for name, label, run_k, run_p, _cmp in kernel_cases(dev):
        k_ms, p_ms = cuda_time_ms(run_k), cuda_time_ms(run_p)
        print(f"[times] {name} {label}: kernel {k_ms!r} ms, plain {p_ms!r} ms; "
              f"card {card}", flush=True)
        ms[name] = (k_ms, p_ms)  # the last case: a full ring for the attention
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dsm_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
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

    errs = phase_kernels(dev)
    engine, launches = phase_serve(dev)
    ms = phase_times(engine, dev, card)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms[name][0], "plain_ms": ms[name][1]}
               for name in ("scale_commit", "decode_attend_commit", "ring_commit")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
