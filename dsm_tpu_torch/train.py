"""Training / finetuning for delayed-streams LMs (counterpart of
``dsm_tpu/train.py``).

Next-frame prediction over the delayed token streams:

  inputs at frame t  : text[t-1]; audio[t-1, cb0]; audio[t-1-ad, cb>0]
                       (the pattern the streaming sessions feed)
  temporal loss      : CE(text_logits[t], text[t])
  depformer loss     : teacher-forced CE over the K codebook slices, with
                       time folded into the batch axis (each frame's slice
                       chain is independent).

The temporal transformer runs its full-sequence form (``transformer.forward``,
plain PyTorch, as XLA runs it in the JAX package).  The DepFormer steps its
slices with ``transformer.step`` over one ring of B*T rows, as the JAX
function does: the ring commit is the kernel ``ring_commit`` on the card, and
its backward the kernel ``ring_commit_backward`` (``ops/ring_kernels.py``).

The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` written out:
torch's ``clip_grad_norm_`` divides by ``norm + 1e-6`` and scales always,
optax scales by ``max_norm / norm`` only when the norm reaches ``max_norm``;
torch's ``AdamW`` skips a leaf whose ``.grad`` is None, optax decays every
leaf, so a leaf that gets no gradient (tts-1.6b's cross-attention: the loss
passes no voice; the semantic-VAD ``extra_heads``) decays and its moments
decay too.  The step updates the params in place (the JAX step donates
them) and runs where the params lie: nothing moves to the host but the
loss values a caller reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .models import lm as LM
from .ops import norm as norm_mod
from .ops import transformer as T


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lm: LM.LmConfig
    acoustic_delay: int = 2
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    text_loss_weight: float = 1.0
    audio_loss_weight: float = 1.0
    grad_clip: float = 1.0


def build_delayed_inputs(cfg: TrainConfig, text: torch.Tensor, audio: torch.Tensor):
    """(text (B,T), audio (B,T,K)) -> delayed-model inputs, same shapes."""
    lm_cfg = cfg.lm
    b, t = text.shape
    k = audio.shape[-1]
    dev = text.device
    start = torch.full((b, 1), lm_cfg.text_start_token, dtype=text.dtype, device=dev)
    text_in = torch.cat([start, text[:, :-1]], dim=1)
    k_arr = torch.arange(k, device=dev)
    delays = torch.where(k_arr == 0, 1, cfg.acoustic_delay + 1)  # (K,)
    src = torch.arange(t, device=dev)[:, None] - delays[None, :]  # (T, K)
    gathered = audio[:, src.clamp(min=0), k_arr[None, :]]  # (B, T, K)
    audio_in = torch.where((src < 0)[None], lm_cfg.audio_pad_token, gathered)
    return text_in, audio_in.to(audio.dtype)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of f32 logits ``(N, V)`` at integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def temporal_loss(cfg: TrainConfig, params: dict, text: torch.Tensor, audio: torch.Tensor):
    """Returns (text_loss, hidden (B,T,D))."""
    lm_cfg = cfg.lm
    text_in, audio_in = build_delayed_inputs(cfg, text, audio)
    emb = params["text_emb"][text_in]
    for i in range(lm_cfg.audio_codebooks):
        emb = emb + params["audio_embs"][i][audio_in[:, :, i]]
    ys = T.forward(lm_cfg.transformer, params["transformer"], emb)
    ys = norm_mod.apply_norm(lm_cfg.transformer.norm, params["out_norm"], ys)
    logits = ys @ params["text_linear"].to(ys.dtype).T
    return _ce(logits.reshape(-1, logits.shape[-1]), text.reshape(-1)), ys


def depformer_loss(cfg: TrainConfig, params: dict, hidden: torch.Tensor,
                   text: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """Teacher-forced CE over codebook slices; time folded into batch.  The
    slices share one ring of ``B*T`` rows in ``hidden``'s dtype, stepped by
    ``transformer.step``: each slice commits its K/V row into it and attends
    over the rows of the slices before it."""
    lm_cfg = cfg.lm
    dep = lm_cfg.depformer
    dcfg = dep.transformer
    s = dep.num_slices
    b, t, d = hidden.shape
    h = hidden.reshape(b * t, d)
    targets = audio[:, :, :s].reshape(b * t, s)
    dp = params["depformer"]
    kv = T.init_state(dcfg, b * t, cache_dtype=h.dtype, device=h.device)

    losses = []
    last_tok = text.reshape(b * t)
    for i in range(s):  # unrolled over codebook slices
        table = dp["text_emb"] if i == 0 else dp["audio_embs"][i - 1]
        e = table[last_tok]
        if "low_rank" in dp:
            e = e @ dp["low_rank"][i].to(e.dtype).T
        x = h @ dp["linear_in"][i].to(h.dtype).T + e.to(h.dtype)
        y, kv = T.step(dcfg, dp["transformer"][i], kv, x[:, None, :])
        logits = y[:, 0] @ dp["linear_out"][i].to(h.dtype).T
        losses.append(_ce(logits, targets[:, i].clamp(max=lm_cfg.audio_vocab_size - 2)))
        last_tok = targets[:, i]
    return torch.stack(losses).mean()


def loss_fn(cfg: TrainConfig, params: dict, batch: dict):
    text, audio = batch["text"], batch["audio"]
    text_loss, hidden = temporal_loss(cfg, params, text, audio)
    loss = cfg.text_loss_weight * text_loss
    aux = {"text_loss": text_loss}
    if cfg.lm.depformer is not None:
        a_loss = depformer_loss(cfg, params, hidden, text, audio)
        loss = loss + cfg.audio_loss_weight * a_loss
        aux["audio_loss"] = a_loss
    return loss, aux


def leaves(tree) -> list:
    """The tensors of a param tree, in a fixed order (dict keys as stored,
    lists in order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return []


# optax.adamw's defaults, which the JAX optimizer takes.
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    weight_decay=weight_decay))`` with optax's defaults (:data:`B1`,
    :data:`B2`, :data:`EPS`, :data:`EPS_ROOT`)."""

    learning_rate: float
    weight_decay: float
    grad_clip: float

    def init(self, params) -> dict:
        """Zero moments beside every leaf, on its device; the step count."""
        ps = leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p) for p in ps],
                "nu": [torch.zeros_like(p) for p in ps]}

    @torch.no_grad()
    def step(self, params, state: dict) -> None:
        """Update every leaf of ``params`` in place from its ``.grad`` (None:
        a zero gradient), then clear the gradients.  optax's order of
        operations; nothing is read back to the host."""
        ps = leaves(params)
        grads = [p.grad for p in ps]
        sq = [torch.sum(g.float() * g.float()) for g in grads if g is not None]
        g_norm = torch.sqrt(torch.stack(sq).sum()) if sq else None
        state["count"] += 1
        n = np.float32(state["count"])
        # 1 - b ** count in f32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(B1) ** n)
        bc2 = float(np.float32(1) - np.float32(B2) ** n)
        for p, g, mu, nu in zip(ps, grads, state["mu"], state["nu"]):
            if g is None:  # (1 - b) * 0 + b * m
                mu.mul_(B1)
                nu.mul_(B2)
            else:
                g = torch.where(g_norm < self.grad_clip, g,
                                (g / g_norm.to(g.dtype)) * self.grad_clip)
                mu.copy_((1 - B1) * g + B1 * mu)
                nu.copy_((1 - B2) * (g * g) + B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + EPS_ROOT) + EPS)
            u = (u + self.weight_decay * p) * -self.learning_rate
            p.add_(u)
            p.grad = None


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(cfg.learning_rate, cfg.weight_decay, cfg.grad_clip)


def make_train_step(cfg: TrainConfig, opt: AdamW):
    """-> ``train_step(params, opt_state, batch)`` -> ``(params, opt_state,
    loss, aux)``: one forward and backward pass and one optimizer update, the
    params and the optimizer state updated in place (the same objects come
    back, as the JAX step's donated buffers).  ``loss`` and ``aux``'s values
    are 0-d tensors on the params' device."""

    def train_step(params, opt_state, batch):
        for p in leaves(params):
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            loss, aux = loss_fn(cfg, params, batch)
            loss.backward()
        opt.step(params, opt_state)
        return params, opt_state, loss.detach(), {k: v.detach() for k, v in aux.items()}

    return train_step

