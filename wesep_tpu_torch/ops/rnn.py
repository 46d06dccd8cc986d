"""LSTM entry points over explicit weights.

Counterpart of wesep_tpu/ops/rnn.py, with the JAX package's switches:

- `bilstm` takes the fused layer `cuda_lstm.bilstm_layer`, or under
  WESEP_LSTM_LAYER=0 (and for a D that the fused layer does not take) the
  two-kernel layer `cuda_lstm_fused.bilstm_fused` (the input projection a
  library product, the kernels only the recurrence);
- `lstm` (unidirectional) takes the two-kernel layer
  `cuda_lstm_fused.lstm_fused`;
- `bilstm_unfold` (TF-GridNet's unfold + BiLSTM) takes, with
  WESEP_LSTM_UNFOLD=1, the unfold-fused layer
  `cuda_lstm_unfold.bilstm_layer_unfold`, which never materialises the
  frames on the card; otherwise it unfolds with torch ops and runs
  `bilstm`.

Each layer is an autograd Function that launches its CUDA kernels for CUDA
tensors and runs their plain versions for CPU tensors; `plain` runs the
plain versions on any device. Before that, each route checks its kernels'
limits from the shapes alone: a layer they do not take runs `lstm_scan`, a
loop of torch ops, as the JAX package runs lax.scan where its Pallas
kernels do not apply (`rnn._use_pallas`).
"""

import os

import torch

from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused, cuda_lstm_unfold
from wesep_tpu_torch.ops.cuda_lstm import bilstm_layer
from wesep_tpu_torch.ops.cuda_lstm_fused import bilstm_fused, lstm_fused
from wesep_tpu_torch.ops.cuda_lstm_unfold import (
    bilstm_layer_unfold,
    unfold_frames,
)

__all__ = ["lstm", "lstm_scan", "bilstm", "bilstm_unfold", "unfold_frames"]


def lstm_scan(x, wx, wh, b, reverse: bool = False):
    """Unidirectional LSTM as a loop of torch ops, differentiated by
    autograd: the route of a layer that no kernel takes (the JAX package's
    lax.scan, `rnn._lstm_scan`). xw = x @ Wx + b in f32, rounded to x's
    dtype; Wh as stored; h carried in x's dtype and c in f32."""
    dtype = x.dtype
    hidden = wh.shape[0]
    xw = (torch.matmul(x.float(), wx.float()) + b.float()).to(dtype)
    h = x.new_zeros(x.shape[0], hidden)
    c = x.new_zeros(x.shape[0], hidden, dtype=torch.float32)
    ys = [None] * x.shape[1]
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for t in steps:
        g = xw[:, t].float() + torch.matmul(h.float(), wh.float())
        i, f, gg, o = g.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
        ys[t] = h
    return torch.stack(ys, dim=1)


def lstm(x, wx, wh, b, reverse: bool = False, plain: bool = False):
    """Unidirectional LSTM. x: [B, T, D]; wx: [D, 4H]; wh: [H, 4H];
    b: [4H] -> [B, T, H]. The two-kernel layer where its kernels take H,
    else the scan; `plain` runs the kernels' plain versions on any
    device."""
    if cuda_lstm_fused.kernel_fits(wh.shape[0]):
        return lstm_fused(x, wx, b, wh, reverse, plain=plain)
    return lstm_scan(x, wx, wh, b, reverse)


def bilstm(x, wx_f, wh_f, b_f, wx_b, wh_b, b_b, plain: bool = False):
    """Bidirectional LSTM -> [B, T, 2H], forward then backward features.

    Takes (wx, wh, b) per direction like wesep_tpu.ops.rnn.bilstm; the
    layer wrappers take them as (wx, b, wh). The fused layer where its
    kernels take the shapes (not under WESEP_LSTM_LAYER=0), else the
    two-kernel one where its kernels take H (they have no limit on D),
    else the scan in both directions; `plain` runs the kernels' plain
    versions on any device."""
    hidden = wh_f.shape[0]
    if (os.environ.get("WESEP_LSTM_LAYER", "1") != "0"
            and cuda_lstm.kernel_fits(x.shape[-1], hidden)):
        return bilstm_layer(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, plain=plain)
    if cuda_lstm_fused.kernel_fits(hidden):
        return bilstm_fused(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, plain=plain)
    return torch.cat([lstm_scan(x, wx_f, wh_f, b_f),
                      lstm_scan(x, wx_b, wh_b, b_b, reverse=True)], dim=-1)


def bilstm_unfold(x, wx_f, wh_f, b_f, wx_b, wh_b, b_b, ks: int, hs: int,
                  plain: bool = False):
    """unfold(ks, hs) + bidirectional LSTM -> [B, T', 2H].

    x: [B, L, C]; weights in the unfolded layout ([ks * C, 4H],
    channel-major rows), the same parameters as
    bilstm(unfold_frames(x, ks, hs), ...). WESEP_LSTM_UNFOLD=1 takes the
    unfold-fused layer where its kernels take the shapes, as it takes the
    JAX package's unfold-fused kernel; `plain` runs the kernels' plain
    versions on any device."""
    if (os.environ.get("WESEP_LSTM_UNFOLD") == "1"
            and cuda_lstm_unfold.kernel_fits(tuple(x.shape), ks, hs,
                                             wh_f.shape[0])):
        return bilstm_layer_unfold(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks,
                                   hs, plain=plain)
    return bilstm(unfold_frames(x, ks, hs), wx_f, wh_f, b_f, wx_b, wh_b, b_b,
                  plain=plain)
