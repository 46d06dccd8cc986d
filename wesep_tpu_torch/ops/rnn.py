"""LSTM entry points over explicit weights.

Counterpart of wesep_tpu/ops/rnn.py. `bilstm` goes to the fused layer
`cuda_lstm.bilstm_layer`, an autograd Function that launches the CUDA
kernels (forward and backward) for CUDA tensors and runs their plain
versions for CPU tensors. `bilstm_unfold` (TF-GridNet's unfold + BiLSTM)
follows the JAX package's switch: with WESEP_LSTM_UNFOLD=1 it goes to the
unfold-fused layer `cuda_lstm_unfold.bilstm_layer_unfold`, which never
materialises the frames on the card; otherwise it unfolds with torch ops and
runs `bilstm`. The unidirectional
`lstm` has no kernel yet (pallas_lstm `lstm_fused`, still to port): it runs
its plain version on the CPU and raises on CUDA.
"""

import os

import torch

from wesep_tpu_torch.ops.cuda_lstm import bilstm_layer
from wesep_tpu_torch.ops.cuda_lstm_unfold import (
    bilstm_layer_unfold,
    unfold_frames,
)

__all__ = ["lstm", "bilstm", "bilstm_unfold", "unfold_frames"]


def lstm(x, wx, wh, b, reverse: bool = False):
    """Unidirectional LSTM. x: [B, T, D]; wx: [D, 4H]; wh: [H, 4H];
    b: [4H] -> [B, T, H]."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            "unidirectional LSTM has no CUDA kernel yet (pallas_lstm "
            "lstm_fused is still to port); only the CPU path exists"
        )
    dtype = x.dtype
    hidden = wh.shape[0]
    xw = (torch.matmul(x.float(), wx.float()) + b.float()).to(dtype)
    wh32 = wh.float()
    h = x.new_zeros(x.shape[0], hidden, dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = [None] * x.shape[1]
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for t in steps:
        g = xw[:, t].float() + torch.matmul(h, wh32)
        i, f, gg, o = g.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype).float()
        ys[t] = h
    return torch.stack(ys, dim=1).to(dtype)


def bilstm(x, wx_f, wh_f, b_f, wx_b, wh_b, b_b, plain: bool = False):
    """Bidirectional LSTM -> [B, T, 2H], forward then backward features.

    Takes (wx, wh, b) per direction like wesep_tpu.ops.rnn.bilstm; the
    layer wrapper takes them as (wx, b, wh). `plain` runs the kernels'
    plain versions on any device."""
    return bilstm_layer(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, plain=plain)


def bilstm_unfold(x, wx_f, wh_f, b_f, wx_b, wh_b, b_b, ks: int, hs: int,
                  plain: bool = False):
    """unfold(ks, hs) + bidirectional LSTM -> [B, T', 2H].

    x: [B, L, C]; weights in the unfolded layout ([ks * C, 4H],
    channel-major rows), the same parameters as
    bilstm(unfold_frames(x, ks, hs), ...). WESEP_LSTM_UNFOLD=1 takes the
    unfold-fused layer, as it takes the JAX package's unfold-fused kernel;
    `plain` runs the kernels' plain versions on any device."""
    if os.environ.get("WESEP_LSTM_UNFOLD") == "1":
        return bilstm_layer_unfold(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks,
                                   hs, plain=plain)
    return bilstm(unfold_frames(x, ks, hs), wx_f, wh_f, b_f, wx_b, wh_b, b_b,
                  plain=plain)
