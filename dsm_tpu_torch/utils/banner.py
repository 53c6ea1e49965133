"""The worker's start-up banner and config summary box (counterpart of
``dsm_tpu/utils/banner.py``)."""

from __future__ import annotations

import torch

LOGO = r"""
     _                   _
  __| |___ _ __ ___     | |_ _ __  _   _
 / _` / __| '_ ` _ \ ____| __| '_ \| | | |
| (_| \__ \ | | | | |____| |_| |_) | |_| |
 \__,_|___/_| |_| |_|     \__| .__/ \__,_|
                             |_|
 delayed-streams-modeling · PyTorch + CUDA port
"""


def print_banner(cfg, asr_engine, tts_engine, port: int, device="cuda") -> None:
    device = torch.device(device)
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    lines = [
        f"instance : {cfg.instance_name}",
        f"backend  : {device.type} ({count} device(s))",
        f"port     : {port}",
    ]
    for name, m in cfg.modules.items():
        extra = ""
        if m.type in ("Asr", "BatchedAsr") and asr_engine is not None:
            extra = f" batch={asr_engine.batch_size} delay={m.asr_delay_in_tokens}"
        lines.append(f"module   : {name} [{m.type}] {m.path}{extra}")
    width = max(len(l) for l in lines) + 2
    print(LOGO)
    print("┌" + "─" * width + "┐")
    for l in lines:
        print("│ " + l.ljust(width - 1) + "│")
    print("└" + "─" * width + "┘")
