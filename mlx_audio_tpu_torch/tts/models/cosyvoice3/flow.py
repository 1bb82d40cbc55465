"""CosyVoice3's flow: the pre-lookahead convolutions, a ×2 repeat and the
DiT CFM (counterpart of `mlx_audio_tpu/tts/models/cosyvoice3/flow.py`).

The cosine-scheduled Euler solve with classifier-free guidance is an eager
loop of `n_timesteps` DiT calls, each over the (cond, uncond) pair stacked
on the batch axis (B = 2 for one request). Its initial noise is a standard
normal draw from a `torch.Generator` (the JAX package's from a PRNG key),
so it matches in distribution only; `initial_noise` is the one place it is
drawn, and `noise` passes a draw in. The ODE state stays float32; the DiT
runs in mu's dtype. Padding tokens past `token_len` feed zeroed embeddings;
the unmasked DiT attends over them, as the JAX package's does."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import Conv1d, Embedding, Linear
from .dit import DiT

__all__ = ["CosyVoice3ConditionalCFM", "CausalMaskedDiffWithDiT", "PreLookaheadLayer",
           "build_flow_model"]


class PreLookaheadLayer(nn.Module):
    """A right-context convolution and a causal one, with a residual;
    (B, T, in_channels)."""

    def __init__(self, in_channels: int, channels: int, pre_lookahead_len: int = 3, device=None):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = Conv1d(in_channels, channels, pre_lookahead_len + 1, device=device)
        self.conv2 = Conv1d(channels, in_channels, 3, device=device)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if context is None or context.shape[1] == 0:
            h = F.pad(x, (0, 0, 0, self.pre_lookahead_len))
        else:
            h = torch.cat([x, context], dim=1)
            rem = self.pre_lookahead_len - context.shape[1]
            if rem > 0:
                h = F.pad(h, (0, 0, 0, rem))
        h = F.leaky_relu(self.conv1(h), negative_slope=0.01)
        return self.conv2(F.pad(h, (0, 0, 2, 0))) + x


class CosyVoice3ConditionalCFM(nn.Module):
    def __init__(self, estimator: DiT, sigma_min: float = 1e-6, t_scheduler: str = "cosine",
                 inference_cfg_rate: float = 0.7):
        super().__init__()
        self.estimator = estimator
        self.sigma_min = sigma_min
        self.t_scheduler = t_scheduler
        self.inference_cfg_rate = inference_cfg_rate

    def initial_noise(self, shape, device, generator: Optional[torch.Generator] = None):
        """The solve's starting point: a standard normal draw (B, T, mel)."""
        return torch.randn(shape, generator=generator, device=device)

    def forward(self, mu, spks, cond, generator: Optional[torch.Generator] = None,
                n_timesteps: int = 10, streaming: bool = False,
                noise: Optional[torch.Tensor] = None):
        """mu (B, T, mu_dim), spks (B, D), cond (B, T, mel) → (mel (B, T,
        mel), None)."""
        B, T = mu.shape[0], mu.shape[1]
        if noise is None:
            noise = self.initial_noise((B, T, cond.shape[-1]), mu.device, generator)
        return self.solve_euler(noise.to(mu.device), mu, spks, cond, n_timesteps,
                                streaming), None

    def solve_euler(self, z, mu, spks, cond, n_timesteps: int, streaming: bool = False):
        """The batched-CFG Euler ODE: (1 + w)·v_cond − w·v_uncond."""
        ts = torch.linspace(0.0, 1.0, n_timesteps + 1, device=mu.device)
        if self.t_scheduler == "cosine":
            ts = 1.0 - torch.cos(ts * 0.5 * math.pi)
        B = mu.shape[0]
        cfg = self.inference_cfg_rate
        cdt = mu.dtype
        mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
        spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
        cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
        x = z.float()
        for i in range(n_timesteps):
            v2 = self.estimator(torch.cat([x, x], dim=0).to(cdt), mu2,
                                ts[i].expand(2 * B).to(cdt), spks2, cond2,
                                streaming=streaming).float()
            x = x + (ts[i + 1] - ts[i]) * ((1.0 + cfg) * v2[:B] - cfg * v2[B:])
        return x.to(cdt)


class CausalMaskedDiffWithDiT(nn.Module):
    """Tokens → mel: the token embedding, the pre-lookahead layer, a ×2
    repeat and the DiT CFM."""

    def __init__(self, input_size: int = 80, output_size: int = 80, spk_embed_dim: int = 192,
                 vocab_size: int = 6561, input_frame_rate: int = 25, token_mel_ratio: int = 2,
                 pre_lookahead_len: int = 3,
                 pre_lookahead_layer: Optional[PreLookaheadLayer] = None,
                 decoder: Optional[CosyVoice3ConditionalCFM] = None, n_timesteps: int = 10,
                 device=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.vocab_size = vocab_size
        self.input_frame_rate = input_frame_rate
        self.token_mel_ratio = token_mel_ratio
        self.pre_lookahead_len = pre_lookahead_len
        self.n_timesteps = n_timesteps
        self.input_embedding = Embedding(vocab_size, input_size, device=device)
        self.spk_embed_affine_layer = Linear(spk_embed_dim, output_size, device=device)
        self.pre_lookahead_layer = pre_lookahead_layer or PreLookaheadLayer(
            input_size, input_size, pre_lookahead_len, device=device)
        self.decoder = decoder

    def inference(self, token, token_len, prompt_token, prompt_token_len, prompt_feat,
                  embedding, generator: Optional[torch.Generator] = None,
                  n_timesteps: Optional[int] = None, streaming: bool = False,
                  finalize: bool = True, noise: Optional[torch.Tensor] = None):
        """token (1, T), prompt_token (1, Tp), prompt_feat (1, 2·Tp, mel),
        embedding (1, spk_dim) → (mel (1, 2T, mel) float32 past the prompt,
        None)."""
        wdt = self.pre_lookahead_layer.conv1.weight.dtype
        emb = embedding.float()
        emb = emb / torch.sqrt((emb * emb).sum(-1, keepdim=True) + 1e-8)
        emb = self.spk_embed_affine_layer(emb.to(wdt))
        tokens = torch.cat([prompt_token, token], dim=1)
        total_len = prompt_token_len + token_len
        valid = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                 < total_len[:, None])[..., None]
        h = self.input_embedding(tokens.clamp(0, self.vocab_size - 1)).to(wdt)
        h = h * valid.to(h.dtype)
        if finalize:
            h = self.pre_lookahead_layer(h)
        else:
            p = self.pre_lookahead_len
            h = self.pre_lookahead_layer(h[:, :-p], context=h[:, -p:])
        h = h.repeat_interleave(self.token_mel_ratio, dim=1)
        mel_len1 = prompt_feat.shape[1]
        cond = torch.zeros(1, h.shape[1], self.output_size, dtype=h.dtype, device=h.device)
        cond[:, :mel_len1] = prompt_feat.to(h.dtype)
        feat, _ = self.decoder(mu=h, spks=emb, cond=cond, generator=generator,
                               n_timesteps=n_timesteps or self.n_timesteps,
                               streaming=streaming, noise=noise)
        return feat[:, mel_len1:].float(), None


def build_flow_model(input_size: int = 80, output_size: int = 80, spk_embed_dim: int = 192,
                     vocab_size: int = 6561, input_frame_rate: int = 25,
                     token_mel_ratio: int = 2, pre_lookahead_len: int = 3, dit_dim: int = 1024,
                     dit_depth: int = 22, dit_heads: int = 16, dit_dim_head: int = 64,
                     dit_ff_mult: int = 2, cfm_sigma_min: float = 1e-6,
                     cfm_t_scheduler: str = "cosine", cfm_inference_cfg_rate: float = 0.7,
                     n_timesteps: int = 10, static_chunk_size: int = 50,
                     device=None) -> CausalMaskedDiffWithDiT:
    """The flow stack, on `device`."""
    pre = PreLookaheadLayer(input_size, dit_dim, pre_lookahead_len, device=device)
    dit = DiT(dim=dit_dim, depth=dit_depth, heads=dit_heads, dim_head=dit_dim_head,
              ff_mult=dit_ff_mult, mel_dim=output_size, mu_dim=input_size,
              spk_dim=output_size, out_channels=output_size,
              static_chunk_size=static_chunk_size, device=device)
    cfm = CosyVoice3ConditionalCFM(dit, sigma_min=cfm_sigma_min, t_scheduler=cfm_t_scheduler,
                                   inference_cfg_rate=cfm_inference_cfg_rate)
    return CausalMaskedDiffWithDiT(
        input_size=input_size, output_size=output_size, spk_embed_dim=spk_embed_dim,
        vocab_size=vocab_size, input_frame_rate=input_frame_rate,
        token_mel_ratio=token_mel_ratio, pre_lookahead_len=pre_lookahead_len,
        pre_lookahead_layer=pre, decoder=cfm, n_timesteps=n_timesteps, device=device)
