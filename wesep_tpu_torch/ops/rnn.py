"""LSTM entry points over explicit weights.

Counterpart of wesep_tpu/ops/rnn.py. `bilstm` goes to the fused layer
`cuda_lstm.bilstm_layer`, an autograd Function that launches the CUDA
kernels (forward and backward) for CUDA tensors and runs their plain
versions for CPU tensors. The unidirectional
`lstm` has no kernel yet (pallas_lstm `lstm_fused`, still to port): it runs
its plain version on the CPU and raises on CUDA.
"""

import torch

from wesep_tpu_torch.ops.cuda_lstm import bilstm_layer

__all__ = ["lstm", "bilstm"]


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
