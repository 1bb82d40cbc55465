"""Recurrent layers (counterpart of `mlx_audio_tpu/nn/recurrent.py`).

The JAX package runs an LSTM as a `lax.scan` of one fused gate matmul a
step. Here the whole sequence is one call of torch's fused LSTM operator
(`torch.lstm`: cuDNN on the card where cuDNN takes the dtype, ATen's own
fused cell otherwise), in the input's dtype. The parameters keep the JAX
package's names (`Wx`, `Wh`, `bias_ih`, `bias_hh`) and torch's gate order
[i, f, g, o], so `load_jax_params` carries them with no renaming.

A length mask (`valid_len`) follows `lstm_scan`: the carry freezes on
padded steps. The masked run is a packed sequence, whose lengths are read
on the host. `GRU` waits for a model that needs it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

__all__ = ["LSTM", "BiLSTM"]


class LSTM(nn.Module):
    """Single-direction LSTM over (N, T, D) → (N, T, H), with its final
    (h, c) each (N, H).

    With `valid_len` (N,) (every length at least 1), row n runs over its
    first valid_len[n] steps only: forward, the steps after them repeat the
    last hidden state; reversed, the run starts at the last valid step from
    the initial state and the padded steps hold that initial state."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, device=None):
        super().__init__()
        self.Wx = nn.Parameter(torch.empty(4 * hidden_size, input_size, device=device))
        self.Wh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size, device=device))
        if bias:
            self.bias_ih = nn.Parameter(torch.empty(4 * hidden_size, device=device))
            self.bias_hh = nn.Parameter(torch.empty(4 * hidden_size, device=device))
        else:
            self.bias_ih = self.bias_hh = None
        self.hidden_size = hidden_size

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        k = 1.0 / math.sqrt(self.hidden_size)
        self.Wx.data.uniform_(-k, k, generator=generator)
        self.Wh.data.uniform_(-k, k, generator=generator)
        if self.bias_ih is not None:
            self.bias_ih.data.zero_()
            self.bias_hh.data.zero_()

    def forward(self, x: torch.Tensor, hidden=None, reverse: bool = False,
                valid_len: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        N, T, _ = x.shape
        if hidden is None:
            h0 = c0 = x.new_zeros(N, self.hidden_size)
        else:
            h0, c0 = hidden
        params = [self.Wx.to(x.dtype), self.Wh.to(x.dtype)]
        if self.bias_ih is not None:
            params += [self.bias_ih.to(x.dtype), self.bias_hh.to(x.dtype)]
        has_bias = self.bias_ih is not None

        if valid_len is None:
            xs = x.flip(1) if reverse else x
            hs, hT, cT = torch.lstm(xs, (h0[None], c0[None]), params, has_bias,
                                    1, 0.0, False, False, True)
            return (hs.flip(1) if reverse else hs), (hT[0], cT[0])

        # a length beyond T marks every step valid, as the JAX mask does
        valid_len = valid_len.long().clamp(max=T)
        t = torch.arange(T, device=x.device)[None, :]
        vl = valid_len.to(x.device)[:, None]
        valid = t < vl
        if reverse:  # each row's valid prefix, reversed; the padding stays
            order = torch.where(valid, vl - 1 - t, t)
            x = torch.take_along_dim(x, order[..., None], dim=1)
        packed = pack_padded_sequence(x, valid_len.cpu(), batch_first=True,
                                      enforce_sorted=False)
        rows = packed.sorted_indices
        data, hT, cT = torch.lstm(packed.data, packed.batch_sizes,
                                  (h0[rows][None], c0[rows][None]), params, has_bias,
                                  1, 0.0, False, False)
        hs, _ = pad_packed_sequence(
            PackedSequence(data, packed.batch_sizes, rows, packed.unsorted_indices),
            batch_first=True, total_length=T)
        hT, cT = hT[0][packed.unsorted_indices], cT[0][packed.unsorted_indices]
        if reverse:
            hs = torch.take_along_dim(hs, order[..., None], dim=1)
        frozen = h0 if reverse else hT
        return torch.where(valid[..., None], hs, frozen[:, None, :]), (hT, cT)


class BiLSTM(nn.Module):
    """Bidirectional LSTM: forward and backward hidden states concatenated.

    `valid_len` (N,) makes the outputs at valid positions independent of the
    right padding: the forward direction runs over the whole sequence, the
    reversed one starts at each row's last valid step (and emits zeros on
    the padding). The submodule named `forward` is reached through
    `_modules`, since the attribute is this module's own method."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, device=None):
        super().__init__()
        # `add_module` refuses the name of a method; the registry takes it
        self._modules["forward"] = LSTM(input_size, hidden_size, bias, device=device)
        self.backward = LSTM(input_size, hidden_size, bias, device=device)

    def forward(self, x: torch.Tensor, valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        fwd, _ = self._modules["forward"](x)
        bwd, _ = self.backward(x, reverse=True, valid_len=valid_len)
        return torch.cat([fwd, bwd], dim=-1)
