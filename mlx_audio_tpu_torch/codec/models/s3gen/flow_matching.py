"""The conditional flow-matching solver with classifier-free guidance
(counterpart of `mlx_audio_tpu/codec/models/s3gen/flow_matching.py`).

The JAX package runs the Euler solve as one `lax.fori_loop`; here it is an
eager loop of n_timesteps estimator calls, each over the [cond, uncond]
pair stacked on the batch axis. The ODE state stays float32; the estimator
runs in mu's dtype. The initial noise is drawn from a `torch.Generator`
(the JAX package's from a PRNG key), so it matches in distribution only;
`noise` passes a draw in."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

__all__ = ["ConditionalCFM", "CFMParams"]


@dataclass
class CFMParams:
    sigma_min: float = 1e-6
    solver: str = "euler"
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7


class ConditionalCFM(nn.Module):
    """The Euler solver around `estimator`, a ConditionalDecoder."""

    MEL_CHANNELS = 80

    def __init__(self, in_channels: int = 240, cfm_params: Optional[CFMParams] = None,
                 n_spks: int = 1, spk_emb_dim: int = 80, estimator: Optional[nn.Module] = None):
        super().__init__()
        cfm_params = cfm_params or CFMParams()
        self.n_feats = in_channels
        self.spk_emb_dim = spk_emb_dim
        self.t_scheduler = cfm_params.t_scheduler
        self.inference_cfg_rate = cfm_params.inference_cfg_rate
        self.estimator = estimator

    def initial_noise(self, shape, device, generator: Optional[torch.Generator] = None):
        """The solve's starting point: a standard normal draw (B, T, 80)."""
        return torch.randn(shape, generator=generator, device=device)

    def forward(self, mu: torch.Tensor, mask: torch.Tensor, n_timesteps: int,
                generator: Optional[torch.Generator] = None, temperature: float = 1.0,
                spks: Optional[torch.Tensor] = None, cond: Optional[torch.Tensor] = None,
                streaming: bool = False, meanflow: bool = False,
                noise: Optional[torch.Tensor] = None):
        """mu (B, T, C_mu), mask (B, T, 1) → (mel (B, T, 80), None). `meanflow`
        runs the distilled solver without CFG on (t, r)."""
        B, T = mu.shape[0], mu.shape[1]
        if noise is None:
            noise = self.initial_noise((B, T, self.MEL_CHANNELS), mu.device, generator)
        z = noise.to(mu.device, torch.float32) * temperature
        t_span = torch.linspace(0.0, 1.0, n_timesteps + 1, device=mu.device)
        if not meanflow and self.t_scheduler == "cosine":
            t_span = 1.0 - torch.cos(t_span * 0.5 * math.pi)
        if meanflow:
            return self.solve_euler_meanflow(z, t_span, mu, mask, spks, cond, streaming), None
        return self.solve_euler(z, t_span, mu, mask, spks, cond, streaming), None

    def solve_euler_meanflow(self, x, t_span, mu, mask, spks, cond,
                             streaming: bool = False) -> torch.Tensor:
        """The distilled one- or two-step solver, no CFG."""
        B = x.shape[0]
        cdt = mu.dtype
        x = x.float()
        for i in range(t_span.shape[0] - 1):
            t, r = t_span[i], t_span[i + 1]
            dxdt = self.estimator(x.to(cdt), mask, mu, t.expand(B).to(cdt), spks, cond,
                                  streaming=streaming, r=r.expand(B).to(cdt))
            x = x + (r - t) * dxdt.float()
        return x.to(cdt)

    def solve_euler(self, x, t_span, mu, mask, spks, cond,
                    streaming: bool = False) -> torch.Tensor:
        """CFG Euler integration: (1 + w)·v_cond - w·v_uncond, w the
        inference CFG rate."""
        B = x.shape[0]
        cdt = mu.dtype
        mask_in = torch.cat([mask, mask], dim=0)
        mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
        spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0) if spks is not None else None
        cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0) if cond is not None else None
        cfg = self.inference_cfg_rate
        x = x.float()
        for i in range(t_span.shape[0] - 1):
            t = t_span[i]
            dt = t_span[i + 1] - t
            dphi = self.estimator(torch.cat([x, x], dim=0).to(cdt), mask_in, mu_in,
                                  t.expand(2 * B).to(cdt), spks_in, cond_in,
                                  streaming=streaming).float()
            x = x + dt * ((1.0 + cfg) * dphi[:B] - cfg * dphi[B:])
        return x.to(cdt)
