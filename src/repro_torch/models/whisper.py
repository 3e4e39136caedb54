"""Whisper-style encoder-decoder backbone (port of ``repro/models/whisper.py``;
the audio frontend is a stub: callers hand in precomputed frame embeddings).

Encoder: bidirectional self-attention blocks over frames.  Decoder: causal
self-attention, then cross-attention over the encoder output.  Learned
positional embeddings on both sides, LayerNorm and a GELU MLP, as Whisper.
Cross-attention reads the encoder output in every decoder layer, so the
graph is not a chain: the paper's target case.

Every full-sequence attention goes to ``kernels.flash_attention``: the
encoder's (non-causal), the decoder's self-attention (causal) and, unlike
the reference, which calls ``dense_attention`` there, the decoder's
cross-attention (non-causal, Sq ≠ Sk; the same function, ROADMAP.md §3).
One-query cross-attention in ``decode_step`` stays plain, as
``decode_attention`` does (``attention.attend_cache``: on DTensors, on
each rank's shard of the cross K/V).

On a mesh the reference's four constraints hold the residual: whole over
``model`` after each side's embedding, sequence-parallel at each layer's
end; the cross-attention's q, K/V and context split their heads over
``model`` (the flash op runs on head shards) and its output is made whole,
as ``Attention`` does.

Param tree: the reference's (``enc_pos``, ``encoder``, ``enc_norm``,
``embedding``, ``dec_pos``, ``decoder``, ``dec_norm``, ``head``), with
``encoder``/``decoder`` a ``ModuleList`` of layers where the reference
stacks them (``weights.params_from_jax`` unstacks both).  The recomputation
plan enters as ``segment_sizes``/``segment_remat``, applied to each side's
chain of layers, as in the reference.  Decode caches:
``{"cross": {"xk", "xv"}, "self": {"k", "v"}}``, each leaf (n_layers, B,
S, KV, D) in the activation dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from . import attention as attn
from .attention import merge_heads, split_heads
from repro_torch.parallel.sharding import shard
from .layers import (embed, gather_sequence, gelu_mlp, init_normal, layernorm, softmax_xent,
                     unembed)
from .transformer import Attention, _params, scan_over_segments

MAX_DEC_POS = 65_536


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(self.scale, self.bias, x)


class GeluMLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.w_up = nn.Parameter(init_normal((d_model, d_ff), d_model**-0.5, **kw))
        self.w_down = nn.Parameter(init_normal((d_ff, d_model), d_ff**-0.5, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_mlp(self.w_up, self.w_down, x)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device, generator)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, device, generator)

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = h + self.attn(self.ln1(h), positions, causal=False)
        return shard(h + self.mlp(self.ln2(h)), "batch", "seq_act", None)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.self_attn = Attention(cfg, device, generator)
        self.ln_x = LayerNorm(cfg.d_model, device)
        self.cross_attn = Attention(cfg, device, generator)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, device, generator)

    def enc_kv(self, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cross-attention's K and V of the encoder output, (B, T, KV, D)."""
        c, p = self.cfg, self.cross_attn
        B, T, _ = enc_out.shape
        dt = enc_out.dtype
        enc_out = gather_sequence(enc_out)
        k = split_heads(enc_out @ p.wk.to(dt), c.n_kv_heads, c.head_dim)
        v = split_heads(enc_out @ p.wv.to(dt), c.n_kv_heads, c.head_dim)
        return (shard(k, "batch", None, "kv_heads", None),
                shard(v, "batch", None, "kv_heads", None))

    def cross(self, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
              attend) -> torch.Tensor:
        """x (B, S, D) queries against the encoder's K/V through ``attend``."""
        c, p = self.cfg, self.cross_attn
        B, S, _ = x.shape
        q = split_heads(gather_sequence(x) @ p.wq.to(x.dtype), c.n_heads, c.head_dim)
        ctx = shard(attend(shard(q, "batch", None, "heads", None), xk, xv),
                    "batch", None, "heads", None)
        out = merge_heads(ctx) @ p.wo.to(x.dtype)
        return shard(out, "batch", None, "model")

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                enc_out: torch.Tensor) -> torch.Tensor:
        h = h + self.self_attn(self.ln1(h), positions)
        xk, xv = self.enc_kv(enc_out)
        h = h + self.cross(self.ln_x(h), xk, xv,
                           lambda q, k, v: flash_attention(q, k, v, causal=False))
        return shard(h + self.mlp(self.ln2(h)), "batch", "seq_act", None)

    def decode(self, h: torch.Tensor, self_cache: Dict[str, torch.Tensor],
               cross: Dict[str, torch.Tensor], position: torch.Tensor) -> torch.Tensor:
        h = h + self.self_attn.decode(self.ln1(h), self_cache, position)
        h = h + self.cross(self.ln_x(h), cross["xk"], cross["xv"], attn.attend_cache)
        return h + self.mlp(self.ln2(h))


class WhisperModel(nn.Module):
    """Encoder-decoder: frames (B, T, D) and tokens (B, S) → f32 logits.

    Parameters are f32 masters on ``device`` (CUDA unless the caller asks
    for the CPU), drawn from ``generator`` (default: seed 0 on ``device``).
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.n_units = cfg.n_layers  # layers on each side
        device = torch.device(device)
        if generator is None and device.type != "meta":  # meta: shapes only
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, generator=generator)
        d = cfg.d_model
        self.enc_pos = nn.Parameter(init_normal((cfg.frontend_seq or 1500, d), 0.02, **kw))
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, device, generator) for _ in range(cfg.n_layers))
        self.enc_norm = LayerNorm(d, device)
        self.embedding = _params(embed=init_normal((cfg.vocab_size, d), 1.0, **kw))
        self.dec_pos = nn.Parameter(init_normal((MAX_DEC_POS, d), 0.02, **kw))
        self.decoder = nn.ModuleList(
            DecoderLayer(cfg, device, generator) for _ in range(cfg.n_layers))
        self.dec_norm = LayerNorm(d, device)
        self.head = _params(unembed=init_normal((cfg.vocab_size, d), d**-0.5, **kw))

    # ----------------------------------------------------------- encoder

    def encode(self, frames: torch.Tensor,
               segment_sizes: Optional[Tuple[int, ...]] = None,
               segment_remat: Optional[Tuple[bool, ...]] = None) -> torch.Tensor:
        """frames (B, T, D): the precomputed conv-frontend output (stub)."""
        dt = self.cfg.activation_dtype
        T = frames.shape[1]
        h = shard(frames.to(dt) + self.enc_pos[:T].to(dt)[None], "batch", None, "model")
        positions = torch.arange(T, device=h.device)[None, :]
        h = scan_over_segments(h, self.encoder, lambda layer, x: layer(x, positions),
                               segment_sizes, segment_remat)
        return self.enc_norm(h)

    # ----------------------------------------------------------- decoder

    def decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                     segment_sizes: Optional[Tuple[int, ...]] = None,
                     segment_remat: Optional[Tuple[bool, ...]] = None) -> torch.Tensor:
        dt = self.cfg.activation_dtype
        S = tokens.shape[1]
        h = embed(self.embedding.embed, tokens, dt) + self.dec_pos[:S].to(dt)[None]
        h = shard(h, "batch", None, "model")
        positions = torch.arange(S, device=h.device)[None, :]
        h = scan_over_segments(h, self.decoder,
                               lambda layer, x: layer(x, positions, enc_out),
                               segment_sizes, segment_remat)
        return unembed(self.head.unembed, self.dec_norm(h))

    def loss(self, batch: Dict[str, torch.Tensor],
             segment_sizes: Optional[Tuple[int, ...]] = None,
             segment_remat: Optional[Tuple[bool, ...]] = None) -> torch.Tensor:
        enc_out = self.encode(batch["frames"], segment_sizes, segment_remat)
        logits = self.decode_train(batch["tokens"], enc_out, segment_sizes, segment_remat)
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:])

    # ------------------------------------------------------------- decode

    @torch.no_grad()
    def init_caches(self, frames: torch.Tensor, max_seq: int) -> Dict[str, Dict]:
        """Run the encoder once on frames (B, T, D); precompute each decoder
        layer's cross K/V; zero self-attention caches for B sequences of up
        to ``max_seq`` tokens."""
        cfg = self.cfg
        dt = cfg.activation_dtype
        enc_out = self.encode(frames)
        kv = [layer.enc_kv(enc_out) for layer in self.decoder]
        shape = (cfg.n_layers, frames.shape[0], max_seq, cfg.n_kv_heads, cfg.head_dim)
        kw = dict(dtype=dt, device=enc_out.device)
        return {
            "cross": {"xk": torch.stack([k for k, _ in kv]),
                      "xv": torch.stack([v for _, v in kv])},
            "self": {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)},
        }

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: Dict[str, Dict],
                    position: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Dict]]:
        """tokens (B, 1), position (B,) → (f32 logits (B, 1, V), caches).

        Each row's new k and v go into the self-attention caches in place;
        the cross K/V are read only.  The returned caches are the given ones.
        """
        dt = self.cfg.activation_dtype
        h = embed(self.embedding.embed, tokens, dt) + self.dec_pos[position].to(dt)[:, None]
        for i, layer in enumerate(self.decoder):
            h = layer.decode(h, {k: t[i] for k, t in caches["self"].items()},
                             {k: t[i] for k, t in caches["cross"].items()}, position)
        return unembed(self.head.unembed, self.dec_norm(h)), caches
