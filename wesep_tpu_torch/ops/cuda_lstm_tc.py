"""The bf16 forward and backward of the LSTM layers on tensor cores: CUDA
kernel wrappers, plain versions and the route gates.

The forward, for all four LSTM layers (csrc/lstm_forward_tc.cu over
csrc/lstm_tc.cuh, whose header describes the design and its bounds): the
input projection xw = x @ Wx + b of every step as one tensor-core product,
f32 (`lstm_project`, the layers that project x: `cuda_lstm.bilstm_layer`
and `cuda_lstm_unfold.bilstm_layer_unfold`; the two-kernel layers bring xw
rounded to bf16), then the recurrence over thread-block clusters, each
block holding its slice of Wh on chip (`lstm_forward_chain`). A layer takes
it where `forward_fits` says so (the same shapes as `backward_fits`);
`split_forward` composes the two as the card does, from the kernels or,
with `plain`, from their plain versions, on any device; given f32 operands
it composes the f32 forward of ops/cuda_lstm_f32.py (FMA kernels, its gate
`f32_forward_fits`), so `layer_forward`, `unfold_forward` and
`fused_forward` serve both dtypes.

One backward for all four LSTM layers (`cuda_lstm.bilstm_layer`,
`cuda_lstm_unfold.bilstm_layer_unfold`, `cuda_lstm_fused.bilstm_fused` and
`lstm_fused`), in csrc/lstm_backward_tc.cu over csrc/lstm_tc.cuh, whose
header describes the design and its bounds. It reorders the adjoint: the
gates of every step in one tensor-core product, stored activated
(`lstm_gates`), a serial chain over thread-block clusters that carries only
dh = dg @ Wh^T and writes the rounded dgates dg (`lstm_adjoint_chain`),
then dx = dg @ Wx^T (`lstm_dx`, the layers that project x) and dW =
[x ; h_{t-1}]^T @ dg (`lstm_wgrad`) over the stored dg.

A layer takes it where `backward_fits` says so: a bf16 stream, H of 64,
128, 192 or 256 (4 blocks of a cluster own H / 4 units each), a row of x of
D % 8 == 0 values (16-byte copies; for the unfold-fused layer C % 8 == 0)
and B * T <= 65535 * 128 rows. The route decides from the shapes alone,
before any launch; f32 and other shapes keep the kernels of
csrc/bilstm_backward.cuh. Each wrapper launches its kernel on CUDA tensors
and counts the launch (`.launches`); `split_backward` composes the four
steps as the card does, from the kernels or, with `plain`, from their plain
versions, on any device.

Rows of A = [x ; h_{t-1}] come from the stream in place (`RowSpec`): rows
of x [B, T, D]; the frames of unfold(ks, hs) over x [B, L, C], in k-major
order (element k * C + c: ks * C contiguous values of x; Wx is permuted to
that order here and dWx and dx back to the weights' channel-major order);
or h alone (the two-kernel layers, whose gates start from xw).
"""

import ctypes
import dataclasses

import torch

from wesep_tpu_torch.ops.cuda_lstm import _check, _entry, _launch
from wesep_tpu_torch.ops.cuda_lstm_unfold import fold_frames

__all__ = ["RowSpec", "ROW_X", "ROW_UNFOLD", "ROW_H", "CLUSTER", "CHAIN_ROWS",
           "FORWARD_ROWS", "CHAIN_HIDDEN", "forward_fits", "backward_fits",
           "wgrad_splits", "lstm_project", "lstm_forward_chain",
           "forward_clusters", "lstm_project_reference",
           "lstm_forward_chain_reference", "split_forward", "layer_forward",
           "unfold_forward", "fused_forward",
           "lstm_gates", "lstm_adjoint_chain", "lstm_dx", "lstm_wgrad",
           "gate_rows", "lstm_gates_reference",
           "lstm_adjoint_chain_reference", "lstm_dx_reference",
           "lstm_wgrad_reference", "split_backward", "layer_backward",
           "unfold_backward", "fused_backward", "to_k_major"]

ROW_X, ROW_UNFOLD, ROW_H = 0, 1, 2
CLUSTER = 4        # blocks of a cluster of the chain kernel
CHAIN_ROWS = 32    # batch rows of a cluster of the adjoint chain
FORWARD_ROWS = 64  # batch rows of a cluster of the forward chain
CHAIN_HIDDEN = (64, 128, 192, 256)
_MAX_ROWS = 65535 * 128  # a grid dimension of the products, in 128-row tiles
_WGRAD_TILE = (128, 128)  # rows and columns of a weight-gradient block
_SPLIT_ALIGN = 64        # rows a slice of the weight-gradient rows is cut in
_SLOTS = 2 * 132         # weight-gradient blocks in flight: two on each SM


@dataclasses.dataclass(frozen=True)
class RowSpec:
    """Where the x part of row n of A lies: `kind` ROW_X (x [B, T, d]),
    ROW_UNFOLD (frames of unfold(d // c, hs) over x [B, length, c],
    k-major) or ROW_H (no x part, d 0)."""
    kind: int
    d: int
    length: int = 0
    c: int = 0
    hs: int = 0


def backward_fits(dtype, d: int, hidden: int, rows: int, c=None) -> bool:
    """The route gate: whether the layer's backward takes these kernels. A
    bf16 stream; H of 64, 128, 192 or 256; d (the x part of a row, 0 for
    the two-kernel layers) and, for the unfold-fused layer, C multiples of
    8; 0 < B * T <= 65535 * 128."""
    return (dtype == torch.bfloat16 and hidden in CHAIN_HIDDEN
            and d % 8 == 0 and (c is None or (c > 0 and c % 8 == 0))
            and 0 < rows <= _MAX_ROWS)


def forward_fits(dtype, d: int, hidden: int, rows: int, c=None) -> bool:
    """The forward's route gate: whether the layer's forward takes these
    kernels. The shapes of `backward_fits` (the same cluster of 4 blocks
    over H / 4 units each, 16-byte copies of x and the same row limit of
    the product's grid): a bf16 stream, H of 64, 128, 192 or 256, d and C
    multiples of 8, 0 < B * T <= 65535 * 128."""
    return backward_fits(dtype, d, hidden, rows, c)


def wgrad_splits(rows: int, m: int, n: int, dirs: int) -> int:
    """Rows per slice of the weight-gradient product: as many slices as
    keep every block in one wave (two on each of the 132 SMs), none under
    2048 rows, each a multiple of 64."""
    tiles = -(-m // _WGRAD_TILE[0]) * -(-n // _WGRAD_TILE[1]) * dirs
    splits = max(1, min(_SLOTS // tiles, -(-rows // 2048)))
    per = -(-rows // splits)
    return -(-per // _SPLIT_ALIGN) * _SPLIT_ALIGN


def _int_args(spec, batch, t_len, hidden, dirs, reverse):
    return (spec.kind, batch, t_len, spec.d, spec.length, spec.c, spec.hs,
            hidden, dirs, int(reverse))


def _pair(ws):
    """Two per-direction operands, the second None for one direction."""
    return ws[0], ws[1] if len(ws) == 2 else None


# ---- kernel wrappers ----------------------------------------------------------


def lstm_gates(x, ys, wxs, whs, spec, biases=None, xw=None, reverse=False):
    """G [dirs, B, T, 4H] f32, the gates: act([x ; h_{t-1}] @ [Wx ; Wh] +
    b) per direction (h_{t-1} @ Wh + xw for ROW_H), sigmoid of the i, f, o
    columns and tanh of the g ones, on the card. x as `spec` says (None for
    ROW_H), ys [B, T, dirs * H]; wxs (None for ROW_H) and whs one [d, 4H] /
    [H, 4H] per direction, bf16, contiguous (wx k-major for ROW_UNFOLD);
    biases one [4H] f32 per direction, or xw [dirs, B, T, 4H] bf16."""
    dirs = len(whs)
    batch, t_len, width = ys.shape
    hidden = width // dirs
    g = torch.empty(dirs, batch, t_len, 4 * hidden, dtype=torch.float32,
                    device=ys.device)
    wx_f, wx_b = _pair(wxs) if wxs is not None else (None, None)
    wh_f, wh_b = _pair(whs)
    b_f, b_b = _pair(biases) if biases is not None else (None, None)
    _launch(lstm_gates, _entry("lstm_backward_tc", "lstm_tc_gates", 10, 10),
            (x, ys, wx_f, wh_f, wx_b, wh_b, b_f, b_b, xw, g),
            _int_args(spec, batch, t_len, hidden, dirs, reverse), ys.device)
    return g


def lstm_adjoint_chain(g, whs, cs, dys, reverse=False):
    """The serial adjoint on the card -> (dg [dirs, B, T, 4H] bf16, db
    [dirs, 4H] f32, its CHAIN_ROWS-row tiles added here in a fixed
    order). g, the gates' activations, from
    `lstm_gates`; cs [B, T, dirs * H] f32, dys [B, T, dirs * H] bf16."""
    dirs, batch, t_len, h4 = g.shape
    hidden = h4 // 4
    dg = torch.empty(dirs, batch, t_len, h4, dtype=torch.bfloat16,
                     device=g.device)
    db_part = torch.empty(-(-batch // CHAIN_ROWS), dirs, h4,
                          dtype=torch.float32, device=g.device)
    wh_f, wh_b = _pair(whs)
    _launch(lstm_adjoint_chain,
            _entry("lstm_backward_tc", "lstm_tc_chain", 7, 5),
            (g, wh_f, wh_b, cs, dys, dg, db_part),
            (batch, t_len, hidden, dirs, int(reverse)), g.device)
    return dg, db_part.sum(dim=0)


def lstm_dx(dg, wxs):
    """dx [dirs, B, T, d] bf16 = dg @ Wx^T per direction, on the card, each
    f32 sum rounded once."""
    dirs, batch, t_len, h4 = dg.shape
    d = wxs[0].shape[0]
    dx2 = torch.empty(dirs, batch, t_len, d, dtype=torch.bfloat16,
                      device=dg.device)
    wx_f, wx_b = _pair(wxs)
    _launch(lstm_dx, _entry("lstm_backward_tc", "lstm_tc_dx", 4, 4),
            (dg, wx_f, wx_b, dx2), (batch * t_len, d, h4 // 4, dirs),
            dg.device)
    return dx2


def lstm_wgrad(x, ys, dg, spec, reverse=False):
    """dW [dirs, d + H, 4H] f32 = [x ; h_{t-1}]^T @ dg per direction, on
    the card (rows :d dWx, k-major for ROW_UNFOLD; rows d: dWh). Each block
    sums one slice of the B * T rows; the slices are added here in a fixed
    order."""
    dirs, batch, t_len, h4 = dg.shape
    hidden = h4 // 4
    rows = batch * t_len
    per = wgrad_splits(rows, spec.d + hidden, h4, dirs)
    partial = torch.empty(-(-rows // per), dirs, spec.d + hidden, h4,
                          dtype=torch.float32, device=dg.device)
    _launch(lstm_wgrad, _entry("lstm_backward_tc", "lstm_tc_wgrad", 4, 11),
            (x, ys, dg, partial),
            (*_int_args(spec, batch, t_len, hidden, dirs, reverse), per),
            dg.device)
    return partial.sum(dim=0)


def lstm_project(x, wxs, biases, spec, t_len):
    """xw = A @ Wx + b per direction, on the card: bf16 products with f32
    sums, the bias added once, not activated, f32 in the chain's order
    ([dirs, ceil(B / 64), T, 64 * 4H]; `from_chain_order` gives the
    layers' [dirs, B, T, 4H]). x as `spec` says (ROW_X or ROW_UNFOLD, T of
    it the frames), wxs one [d, 4H] bf16 per direction (k-major for
    ROW_UNFOLD), biases one [4H] f32 per direction, all contiguous."""
    dirs = len(wxs)
    batch, h4 = x.shape[0], wxs[0].shape[1]
    xw = torch.empty(dirs, -(-batch // FORWARD_ROWS), t_len,
                     FORWARD_ROWS * h4, dtype=torch.float32, device=x.device)
    wx_f, wx_b = _pair(wxs)
    b_f, b_b = _pair(biases)
    _launch(lstm_project, _entry("lstm_forward_tc", "lstm_tc_project", 6, 9),
            (x, wx_f, wx_b, b_f, b_b, xw),
            (spec.kind, batch, t_len, spec.d, spec.length, spec.c, spec.hs,
             h4 // 4, dirs), x.device)
    return xw


def lstm_forward_chain(xw, whs, reverse=False, with_cs=False, batch=None):
    """The recurrence on the card -> (y [B, T, dirs * H] in whs's dtype
    (bf16), cs [B, T, dirs * H] f32 or None). xw f32 in the chain's order
    from `lstm_project` (B given as `batch`), or bf16 [dirs, B, T, 4H] (the
    two-kernel layers); whs one [H, 4H] bf16 per direction, contiguous."""
    hidden = whs[0].shape[0]
    dirs, t_len = xw.shape[0], xw.shape[2]
    if xw.dtype != torch.float32:
        batch = xw.shape[1]
    elif batch is None:
        raise ValueError("an f32 xw is in the chain's order: give its batch")
    y = torch.empty(batch, t_len, dirs * hidden, dtype=whs[0].dtype,
                    device=xw.device)
    cs = torch.empty(batch, t_len, dirs * hidden, dtype=torch.float32,
                     device=xw.device) if with_cs else None
    wh_f, wh_b = _pair(whs)
    _launch(lstm_forward_chain,
            _entry("lstm_forward_tc", "lstm_tc_forward", 5, 6),
            (xw, wh_f, wh_b, y, cs),
            (batch, t_len, hidden, dirs, int(reverse),
             0 if xw.dtype == torch.float32 else 1), xw.device)
    return y, cs


def _chain_dims(hidden):
    """(row splits, 8-unit groups, 16-row tiles a warp) of the chain's
    blocks at this hidden size (FwdShape of csrc/lstm_tc.cuh)."""
    groups = hidden // CLUSTER // 8
    splits = 1 if groups >= 6 else 2
    return splits, groups, FORWARD_ROWS // splits // 16


def from_chain_order(xw, batch):
    """xw in the chain's order -> [dirs, B, T, 4H] (the inverse of the
    layout ChainXw of csrc/lstm_tc.cuh: per tile and step, [rank][warp]
    [piece][lane][4] with warp = (row split, group), piece = (16-row tile,
    gate), lane = (row % 8, unit pair), and (half, unit % 2) the 4)."""
    dirs, tiles, t_len, n = xw.shape
    hidden = n // FORWARD_ROWS // 4
    splits, groups, mi = _chain_dims(hidden)
    v = xw.view(dirs, tiles, t_len, CLUSTER, splits, groups, mi, 4, 8, 4, 2,
                2)
    # rows (split, 16-row tile, half, row % 8); columns (gate, rank, group,
    # unit pair, unit % 2)
    v = v.permute(0, 1, 4, 6, 10, 8, 2, 7, 3, 5, 9, 11)
    return v.reshape(dirs, tiles * FORWARD_ROWS, t_len, 4 * hidden)[:, :batch]


def forward_clusters(hidden: int) -> int:
    """How many clusters of the forward chain at this hidden size the card
    runs at once (cudaOccupancyMaxActiveClusters)."""
    out = ctypes.c_int(0)
    err = _entry("lstm_forward_tc", "lstm_tc_forward_clusters", 1, 1)(
        ctypes.addressof(out), hidden, None)
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {err}")
    return out.value


for _fn in (lstm_gates, lstm_adjoint_chain, lstm_dx, lstm_wgrad,
            lstm_project, lstm_forward_chain):
    _fn.launches = 0


# ---- plain versions -----------------------------------------------------------


def _walks_back(d: int, dirs: int, reverse: bool) -> bool:
    return (dirs == 2 and d == 1) != bool(reverse)


def x_rows(x, spec, t_len):
    """The x part of A, [B, T, d] f32, as `spec` says: the rows of x, or
    the k-major frames of unfold(d // c, hs) (ROW_UNFOLD); None for
    ROW_H."""
    if spec.kind == ROW_X:
        return x.float()
    if spec.kind == ROW_UNFOLD:
        ks = spec.d // spec.c
        # [B, T', C, ks] -> k-major frames [B, T', ks * C]
        return x.float().unfold(1, ks, spec.hs)[:, :t_len] \
            .transpose(2, 3).reshape(x.shape[0], t_len, spec.d)
    return None


def gate_rows(x, ys, spec, dirs, reverse=False):
    """A [dirs, B, T, d + H] f32: row (b, t) of direction d is [x part ;
    h_{t-1}], h_{t-1} the row of ys one step back in that direction's walk,
    zero at the boundary; the x part as `x_rows` gives it."""
    batch, t_len, width = ys.shape
    hidden = width // dirs
    xs = x_rows(x, spec, t_len)
    zero = ys.new_zeros(batch, 1, hidden, dtype=torch.float32)
    out = []
    for d in range(dirs):
        y32 = ys[..., d * hidden:(d + 1) * hidden].float()
        h_prev = torch.cat([y32[:, 1:], zero], dim=1) \
            if _walks_back(d, dirs, reverse) \
            else torch.cat([zero, y32[:, :-1]], dim=1)
        out.append(h_prev if xs is None else torch.cat([xs, h_prev], dim=-1))
    return torch.stack(out)


def lstm_project_reference(x, wxs, biases, spec, t_len):
    """Plain version of `lstm_project`: f32 sums of the x part of A and Wx
    as the kernel reads them (in the stream's dtype), plus the bias."""
    xs = x_rows(x, spec, t_len)
    return torch.stack([torch.matmul(xs, w.float()) + b.float()
                        for w, b in zip(wxs, biases)])


def _block_columns(hidden):
    """The gate columns of each of the CLUSTER blocks: block r owns units
    [r H / CLUSTER, (r + 1) H / CLUSTER) and their four gates."""
    hu = hidden // CLUSTER
    return [torch.tensor([q * hidden + r * hu + j for q in range(4)
                          for j in range(hu)]) for r in range(CLUSTER)]


def lstm_forward_chain_reference(xw, whs, reverse=False, with_cs=False):
    """Plain version of `lstm_forward_chain`, step by step with the
    kernel's partition and rounding points: each block's gate columns g =
    xw + h_{t-1} @ Wh[:, own] in f32 (xw widened to f32, h_{t-1} and Wh in
    whs's dtype), the activations and c in f32, h rounded to whs's dtype
    as it enters the next product and y. -> (y [B, T, dirs * H] in whs's
    dtype, cs [B, T, dirs * H] f32 or None)."""
    dtype = whs[0].dtype
    dirs, batch, t_len, h4 = xw.shape
    hidden = h4 // 4
    cols = _block_columns(hidden)
    ys, cs = [], []
    for d in range(dirs):
        wh32 = whs[d].float()
        h = xw.new_zeros(batch, hidden, dtype=torch.float32)
        c = torch.zeros_like(h)
        y_d, c_d = [None] * t_len, [None] * t_len
        steps = range(t_len - 1, -1, -1) if _walks_back(d, dirs, reverse) \
            else range(t_len)
        for t in steps:
            xw_t = xw[d, :, t].float()
            g = torch.empty_like(xw_t)
            for own in cols:
                g[:, own] = xw_t[:, own] + torch.matmul(h, wh32[:, own])
            i, f, gg, o = g.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype).float()
            y_d[t], c_d[t] = h, c
        ys.append(torch.stack(y_d, dim=1))
        cs.append(torch.stack(c_d, dim=1))
    y = torch.cat(ys, dim=-1).to(dtype)
    return y, (torch.cat(cs, dim=-1) if with_cs else None)


def lstm_gates_reference(x, ys, wxs, whs, spec, biases=None, xw=None,
                         reverse=False):
    """Plain version of `lstm_gates`: f32 sums of the operands as the
    kernel reads them (weights in the stream's dtype), then the bias or
    xw, then the activations."""
    dirs = len(whs)
    a = gate_rows(x, ys, spec, dirs, reverse)
    out = []
    for d in range(dirs):
        w = whs[d].float() if wxs is None \
            else torch.cat([wxs[d].float(), whs[d].float()])
        base = xw[d].float() if xw is not None else biases[d].float()
        i, f, g, o = (torch.matmul(a[d], w) + base).chunk(4, dim=-1)
        out.append(torch.cat([torch.sigmoid(i), torch.sigmoid(f),
                              torch.tanh(g), torch.sigmoid(o)], dim=-1))
    return torch.stack(out)


def lstm_adjoint_chain_reference(g, whs, cs, dys, reverse=False):
    """Plain version of `lstm_adjoint_chain`, step by step with the
    kernel's rounding points and partition: dgates in f32, rounded to the
    stream's dtype (dys's) as dg; dh the sum, in rank order, of the
    CLUSTER blocks' products over their own gate columns; db the sum over
    steps of the unrounded dgates, then over each CHAIN_ROWS-row tile's
    rows, then over the tiles in order. -> (dg [dirs, B, T, 4H], db
    [dirs, 4H] f32)."""
    dtype = dys.dtype
    dirs, batch, t_len, h4 = g.shape
    hidden = h4 // 4
    cols = _block_columns(hidden)
    dg = torch.empty(dirs, batch, t_len, h4, dtype=dtype, device=g.device)
    zeros = g.new_zeros(batch, hidden)
    tiles = [slice(k, k + CHAIN_ROWS) for k in range(0, batch, CHAIN_ROWS)]
    dbs = []
    for d in range(dirs):
        wh32 = whs[d].to(dtype).float()
        part = slice(d * hidden, (d + 1) * hidden)
        c, dy = cs[..., part], dys[..., part].float()
        dh, dc = zeros, zeros
        db_rows = g.new_zeros(batch, h4)
        back = _walks_back(d, dirs, reverse)
        steps = range(t_len) if back else range(t_len - 1, -1, -1)
        for t in steps:
            tp = t + 1 if back else t - 1
            c_prev = c[:, tp] if 0 <= tp < t_len else zeros
            i, f, gg, o = g[d, :, t].split(hidden, dim=-1)
            tanh_c = torch.tanh(c[:, t])
            dh_total = dy[:, t] + dh
            do = dh_total * tanh_c
            dct = dh_total * o * (1.0 - tanh_c * tanh_c) + dc
            dgates = torch.cat([
                (dct * gg) * i * (1.0 - i),
                (dct * c_prev) * f * (1.0 - f),
                (dct * i) * (1.0 - gg * gg),
                do * o * (1.0 - o),
            ], dim=-1)
            lp = dgates.to(dtype)
            dg[d, :, t] = lp
            lpf = lp.float()
            dh = zeros
            for own in cols:
                dh = dh + torch.matmul(lpf[:, own], wh32[:, own].t())
            db_rows += dgates
            dc = dct * f
        dbs.append(torch.stack([db_rows[s].sum(dim=0) for s in tiles])
                   .sum(dim=0))
    return dg, torch.stack(dbs)


def lstm_dx_reference(dg, wxs):
    """Plain version of `lstm_dx`: f32 sums, rounded to dg's dtype."""
    return torch.stack([torch.matmul(dg[d].float(), w.float().t())
                        .to(dg.dtype) for d, w in enumerate(wxs)])


def lstm_wgrad_reference(x, ys, dg, spec, reverse=False):
    """Plain version of `lstm_wgrad`: A^T @ dg per direction, f32."""
    dirs = dg.shape[0]
    a = gate_rows(x, ys, spec, dirs, reverse)
    return torch.stack([torch.einsum("btm,btn->mn", a[d], dg[d].float())
                        for d in range(dirs)])


# ---- the composition ----------------------------------------------------------


def split_forward(x, spec, wxs, biases, whs, xw=None, t_len=None,
                  reverse=False, with_cs=False, plain=False):
    """The forward as the card runs it: the projection (unless xw is given)
    and the recurrence, from the kernels or (`plain`) their plain versions.
    Operands in the stream's dtype and contiguous, biases f32; t_len the
    steps (frames for ROW_UNFOLD) when xw is not given. -> (y [B, T, dirs
    * H] in whs's dtype, cs [B, T, dirs * H] f32 or None). f32 operands
    take the FMA kernels of ops/cuda_lstm_f32.py (`split_forward_f32`)."""
    if whs[0].dtype == torch.float32:
        from wesep_tpu_torch.ops.cuda_lstm_f32 import split_forward_f32

        return split_forward_f32(x, spec, wxs, biases, whs, xw, t_len,
                                 reverse, with_cs, plain)
    project, chain = (lstm_project_reference, lstm_forward_chain_reference) \
        if plain else (lstm_project, lstm_forward_chain)
    if xw is None:
        xw = project(x, wxs, biases, spec, t_len)
        if not plain:  # the kernel's xw is in the chain's order
            return chain(xw, whs, reverse, with_cs, batch=x.shape[0])
    return chain(xw, whs, reverse, with_cs)


def split_backward(x, spec, wxs, biases, whs, ys, cs, dys, xw=None,
                   reverse=False, plain=False):
    """The backward as the card runs it: gates, the chain, dx (where wxs is
    given) and dW, from the kernels or (`plain`) their plain versions.
    Operands in the stream's dtype and contiguous, biases f32 (None when xw
    gives the gates' start). -> (dx [dirs, B, T, d] or None, dW [dirs, d +
    H, 4H] f32, db [dirs, 4H] f32, dg [dirs, B, T, 4H])."""
    if plain:
        gates, chain, dx_of, wgrad = (
            lstm_gates_reference, lstm_adjoint_chain_reference,
            lstm_dx_reference, lstm_wgrad_reference)
    else:
        gates, chain, dx_of, wgrad = (lstm_gates, lstm_adjoint_chain,
                                      lstm_dx, lstm_wgrad)
    g = gates(x, ys, wxs, whs, spec, biases, xw, reverse)
    dg, db = chain(g, whs, cs, dys, reverse)
    del g  # 2 * B * T * 4H f32: free it before the products
    dx2 = dx_of(dg, wxs) if wxs is not None else None
    dw = wgrad(x, ys, dg, spec, reverse)
    return dx2, dw, db, dg


def _cast(w, dtype):
    return w.detach().to(dtype).contiguous()


def _stream(ys, cs, dys, dtype):
    return ys.contiguous(), cs.contiguous(), dys.to(dtype).contiguous()


def _biases(*bs):
    return [b.detach().float().contiguous() for b in bs]


def layer_forward(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, with_cs=False,
                  plain=False):
    """The fused layer's forward (`cuda_lstm.bilstm_layer`) by
    `split_forward`; arguments and results as
    `cuda_lstm.bilstm_layer_reference` with `return_cs`: (ys, cs or
    None)."""
    dtype = x.dtype
    return split_forward(
        x.detach().contiguous(), RowSpec(ROW_X, x.shape[2]),
        [_cast(wx_f, dtype), _cast(wx_b, dtype)], _biases(b_f, b_b),
        [_cast(wh_f, dtype), _cast(wh_b, dtype)], t_len=x.shape[1],
        with_cs=with_cs, plain=plain)


def layer_backward(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs, dys,
                   plain=False):
    """The fused layer's backward (`cuda_lstm.bilstm_layer`) by
    `split_backward`; arguments and results as
    `cuda_lstm.bilstm_layer_backward_reference`. Each direction's dx is
    rounded, then the two are added in x's dtype."""
    dtype, d = x.dtype, x.shape[2]
    _check("ys", ys, (x.shape[0], x.shape[1], 2 * wh_f.shape[0]), x.device)
    dx2, dw, db, _ = split_backward(
        x.detach().contiguous(), RowSpec(ROW_X, d),
        [_cast(wx_f, dtype), _cast(wx_b, dtype)], _biases(b_f, b_b),
        [_cast(wh_f, dtype), _cast(wh_b, dtype)], *_stream(ys, cs, dys, dtype),
        plain=plain)
    return (dx2[0] + dx2[1], dw[0, :d], db[0], dw[0, d:], dw[1, :d], db[1],
            dw[1, d:])


def to_k_major(w, c: int, ks: int):
    """Rows of an unfold layer's weight from channel-major (c * ks + k) to
    k-major (k * C + c) order."""
    return w.reshape(c, ks, -1).transpose(0, 1).reshape(c * ks, -1)


def unfold_forward(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ks: int, hs: int,
                   with_cs=False, plain=False):
    """The unfold-fused layer's forward by `split_forward` over k-major
    frames (Wx permuted by `to_k_major`); arguments and results as
    `cuda_lstm_unfold.bilstm_layer_unfold_reference` with `return_cs`:
    (ys, cs or None)."""
    dtype = x.dtype
    batch, length, c = x.shape
    return split_forward(
        x.detach().contiguous(), RowSpec(ROW_UNFOLD, ks * c, length, c, hs),
        [_cast(to_k_major(w.detach(), c, ks), dtype) for w in (wx_f, wx_b)],
        _biases(b_f, b_b), [_cast(wh_f, dtype), _cast(wh_b, dtype)],
        t_len=(length - ks) // hs + 1, with_cs=with_cs, plain=plain)


def unfold_backward(x, wx_f, b_f, wh_f, wx_b, b_b, wh_b, ys, cs, dys,
                    ks: int, hs: int, plain=False):
    """The unfold-fused layer's backward by `split_backward` over k-major
    frames; arguments and results as
    `cuda_lstm_unfold.bilstm_layer_unfold_backward_reference`: dWx in the
    weights' channel-major row order, the two directions' frame cotangents
    each rounded, added in x's dtype, put back in channel-major order and
    folded onto x's rows."""
    dtype = x.dtype
    batch, length, c = x.shape
    d, frames = ks * c, ys.shape[1]
    dx2, dw, db, _ = split_backward(
        x.detach().contiguous(), RowSpec(ROW_UNFOLD, d, length, c, hs),
        [_cast(to_k_major(w.detach(), c, ks), dtype) for w in (wx_f, wx_b)],
        _biases(b_f, b_b), [_cast(wh_f, dtype), _cast(wh_b, dtype)],
        *_stream(ys, cs, dys, dtype),
        plain=plain)
    du = (dx2[0] + dx2[1]).reshape(batch, frames, ks, c).transpose(2, 3) \
        .reshape(batch, frames, d)
    dwx = dw[:, :d].reshape(2, ks, c, -1).transpose(1, 2).reshape(2, d, -1)
    return (fold_frames(du, ks, hs, length), dwx[0], db[0], dw[0, d:], dwx[1],
            db[1], dw[1, d:])


def fused_forward(xw, whs, reverse=False, with_cs=False, plain=False):
    """The two-kernel layers' recurrence by `split_forward` (xw given, in
    the stream's dtype) -> (ys [B, T, dirs * H], cs or None), as
    `cuda_lstm_fused._recurrence_reference` returns them."""
    return split_forward(None, RowSpec(ROW_H, 0), None, None,
                         [_cast(w, xw.dtype) for w in whs],
                         xw=xw.contiguous(), reverse=reverse, with_cs=with_cs,
                         plain=plain)


def fused_backward(xw, whs, ys, cs, dys, reverse=False, plain=False):
    """The two-kernel layers' adjoint and dWh by `split_backward` (no x
    part, the gates start from xw) -> (dxw [dirs, B, T, 4H] in xw's dtype,
    dWh [dirs, H, 4H] f32, db [dirs, 4H] f32), as
    `cuda_lstm_fused._adjoint_reference` returns them."""
    dtype = xw.dtype
    _, dw, db, dg = split_backward(
        None, RowSpec(ROW_H, 0), None, None, [_cast(w, dtype) for w in whs],
        *_stream(ys, cs, dys, dtype), xw=xw.contiguous(), reverse=reverse,
        plain=plain)
    return dg, dw, db
