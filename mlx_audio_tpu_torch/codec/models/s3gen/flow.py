"""The token-to-mel flow, `CausalMaskedDiffWithXvec` (counterpart of
`mlx_audio_tpu/codec/models/s3gen/flow.py`): the speaker projection, the
token embedding, the upsampling conformer and the CFM solve. Token ids are
clipped into the table (0 .. V - 1) before the lookup, as the JAX package
clips them."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ....nn import Embedding, Linear
from .decoder import ConditionalDecoder
from .encoder import UpsampleConformerEncoder, make_non_pad_mask
from .flow_matching import CFMParams, ConditionalCFM

__all__ = ["CausalMaskedDiffWithXvec"]


class CausalMaskedDiffWithXvec(nn.Module):
    def __init__(self, input_size: int = 512, output_size: int = 80, spk_embed_dim: int = 192,
                 vocab_size: int = 6561, input_frame_rate: int = 25, token_mel_ratio: int = 2,
                 pre_lookahead_len: int = 3, n_timesteps: int = 10,
                 encoder: Optional[UpsampleConformerEncoder] = None,
                 decoder: Optional[ConditionalCFM] = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.input_frame_rate = input_frame_rate
        self.token_mel_ratio = token_mel_ratio
        self.pre_lookahead_len = pre_lookahead_len
        self.n_timesteps = n_timesteps
        self.input_embedding = Embedding(vocab_size, input_size, device=device)
        self.spk_embed_affine_layer = Linear(spk_embed_dim, output_size, device=device)
        self.encoder = encoder or UpsampleConformerEncoder(input_size=input_size,
                                                           output_size=input_size,
                                                           device=device)
        self.encoder_proj = Linear(self.encoder.output_size(), output_size, device=device)
        self.decoder = decoder or ConditionalCFM(
            in_channels=240, cfm_params=CFMParams(),
            estimator=ConditionalDecoder(in_channels=320, out_channels=output_size,
                                         device=device))

    def inference(self, token, token_len, prompt_token, prompt_token_len, prompt_feat, embedding,
                  generator: Optional[torch.Generator] = None, finalize: bool = True,
                  n_timesteps: Optional[int] = None, streaming: bool = False,
                  meanflow: bool = False, noise: Optional[torch.Tensor] = None):
        """token (1, T), prompt mel (1, T_pm, 80), x-vector (1, 192) → (mel
        (1, T_new, 80) of the region past the prompt, None). The flow runs in
        its parameters' dtype."""
        # the conformer's final norm is never quantized: its dtype is the
        # flow's, where an int4 checkpoint packs the embedding's words
        wdt = self.encoder.after_norm.weight.dtype
        emb = embedding / (torch.linalg.vector_norm(embedding.float(), dim=1, keepdim=True)
                           + 1e-8).to(embedding.dtype)
        emb = self.spk_embed_affine_layer(emb.to(wdt))
        prompt_feat = prompt_feat.to(wdt)

        token = torch.cat([prompt_token, token], dim=1)
        token_len = prompt_token_len + token_len
        T = token.shape[1]
        mask = make_non_pad_mask(token_len, T)[..., None].to(emb.dtype)
        token = token.clamp(0, self.input_embedding.weight.shape[0] - 1)
        h = self.input_embedding(token) * mask

        h, _ = self.encoder(h.to(wdt), token_len, streaming=streaming)
        if not finalize:
            h = h[:, : h.shape[1] - self.pre_lookahead_len * self.token_mel_ratio]
        mel_len1 = prompt_feat.shape[1]
        h = self.encoder_proj(h)

        conds = torch.zeros(1, h.shape[1], self.output_size, dtype=h.dtype, device=h.device)
        conds[:, :mel_len1] = prompt_feat
        # the valid mel region is token_len · token_mel_ratio
        dec_mask = (torch.arange(h.shape[1], device=h.device)[None, :, None]
                    < (token_len[:, None, None] * self.token_mel_ratio)).to(h.dtype)
        kw = {"meanflow": True} if meanflow else {}
        feat, _ = self.decoder(mu=h, mask=dec_mask, n_timesteps=n_timesteps or self.n_timesteps,
                               generator=generator, spks=emb, cond=conds, streaming=streaming,
                               noise=noise, **kw)
        return feat[:, mel_len1:], None
