"""The f32 forward of the LSTM layers on the FMA units: CUDA kernel
wrappers, plain versions and the route gate.

For all four LSTM layers (csrc/lstm_forward_f32.cu, whose header describes
the design and its bounds): the input projection xw = x @ Wx + b of every
step as one tiled f32 product (`lstm_f32_project`, the layers that project
x: `cuda_lstm.bilstm_layer` and `cuda_lstm_unfold.bilstm_layer_unfold`; the
two-kernel layers bring xw from their own f32 projection), then the
recurrence over thread-block clusters of H / 32 blocks, each block holding
its slice of Wh in registers and computing the four gates of its own 32
units from the whole h_{t-1} (`lstm_f32_forward_chain`). f32 is what
serving (bin/infer) and bin/train's validation step run. A layer takes it
where `f32_forward_fits` says so; `cuda_lstm_tc.split_forward` composes the
two, from the kernels or, with `plain`, from their plain versions on any
device, for f32 operands by `split_forward_f32` here.

Each wrapper launches its kernel on CUDA tensors and counts the launch
(`.launches`); a build or launch error raises. The chain's batch rows a
cluster (8 to 32) are chosen per call by `rows_per_cluster` from the
clusters the card runs at once.
"""

import ctypes
import functools

import torch

from wesep_tpu_torch.ops.cuda_lstm import _entry, _launch

__all__ = ["F32_HIDDEN", "F32_ROWS", "f32_forward_fits", "rows_per_cluster",
           "f32_forward_clusters", "lstm_f32_project",
           "lstm_f32_forward_chain", "lstm_f32_project_reference",
           "lstm_f32_forward_chain_reference", "from_f32_chain_order",
           "split_forward_f32"]

F32_HIDDEN = (64, 128, 192, 256)  # H / 32 blocks a cluster, 32 units each
F32_ROWS = (8, 12, 16, 20, 32)    # batch rows a cluster the chain takes
_UNITS = 32                       # hidden units of a block (a lane each)
_WARPS = 8                        # warps of a block, each H / 8 rows of k
_MAX_ROWS = 2 ** 31 - 1           # B * T, the kernels' 32-bit row index
# The chain's cycles a step, as its wrapper reckons them to pick the rows a
# cluster: a row costs each of the SM's four schedulers about _ROW_CYCLES *
# H / 256 (its two warps' H / 2 FMAs each and H / 16 broadcast loads of h,
# and their share of the cell update and the exchange); the rest of a step
# is about _STEP_CYCLES whatever R is (a line fitted to the cycles a step
# at 8 to 32 rows that tools/lstm_chain_phases.py --chain f32 counted on an
# H100 at H 256: 4930 at 8 rows, 16056 at 32).
_ROW_CYCLES = 464
_STEP_CYCLES = 1200


def f32_forward_fits(dtype, d: int, hidden: int, rows: int, c=None) -> bool:
    """The route gate of the f32 forward: whether the layer's forward takes
    these kernels. An f32 stream; H of 64, 128, 192 or 256 (clusters of H /
    32 blocks, 32 units each); d (the x part of a row, 0 for the two-kernel
    layers) and, for the unfold-fused layer, C multiples of 8 (16-byte
    copies of x); 0 < B * T < 2^31."""
    return (dtype == torch.float32 and hidden in F32_HIDDEN and d % 8 == 0
            and (c is None or (c > 0 and c % 8 == 0))
            and 0 < rows <= _MAX_ROWS)


@functools.lru_cache(maxsize=None)
def _clusters_at_once(hidden: int, rows: int, device: int) -> int:
    with torch.cuda.device(device):
        return f32_forward_clusters(hidden, rows)


def f32_forward_clusters(hidden: int, rows: int) -> int:
    """How many clusters of the chain at this hidden size and rows a
    cluster the card runs at once (cudaOccupancyMaxActiveClusters)."""
    out = ctypes.c_int(0)
    err = _entry("lstm_forward_f32", "lstm_f32_forward_clusters", 1, 2)(
        ctypes.addressof(out), hidden, rows, None)
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {err}")
    return out.value


def rows_per_cluster(batch: int, dirs: int, hidden: int, device=None) -> int:
    """The chain's batch rows a cluster for this call on card `device` (an
    index; None for the current one): of F32_ROWS, the one whose waves of
    clusters (the card runs `f32_forward_clusters` at once) take the fewest
    cycles a step (the smaller on a tie)."""
    def cycles(r):
        clusters = dirs * -(-batch // r)
        waves = -(-clusters // max(1, _clusters_at_once(hidden, r, device)))
        return waves * (_ROW_CYCLES * hidden // 256 * r + _STEP_CYCLES)

    return min(F32_ROWS, key=cycles)


def _pair(ws):
    """Two per-direction operands, the second None for one direction."""
    return ws[0], ws[1] if len(ws) == 2 else None


# ---- kernel wrappers ----------------------------------------------------------


def lstm_f32_project(x, wxs, biases, spec, t_len, rows):
    """xw = A @ Wx + b per direction, on the card, f32 sums, the bias added
    once, not activated, in the chain's order for `rows` rows a cluster
    ([dirs, ceil(B / rows), T, rows * 4H], the rows of the last tile past B
    not written; `from_f32_chain_order` gives the layers' [dirs, B, T,
    4H]). x f32 as `spec` says (ROW_X or ROW_UNFOLD, T of it the frames),
    wxs one [d, 4H] f32 per direction (k-major for ROW_UNFOLD), biases one
    [4H] f32 per direction, all contiguous."""
    dirs = len(wxs)
    batch, h4 = x.shape[0], wxs[0].shape[1]
    wx_f, wx_b = _pair(wxs)
    b_f, b_b = _pair(biases)
    xw = torch.empty(dirs, -(-batch // rows), t_len, rows * h4,
                     dtype=torch.float32, device=x.device)
    _launch(lstm_f32_project,
            _entry("lstm_forward_f32", "lstm_f32_project", 6, 10),
            (x, wx_f, wx_b, b_f, b_b, xw),
            (spec.kind, batch, t_len, spec.d, spec.length, spec.c, spec.hs,
             h4 // 4, dirs, rows), x.device)
    return xw


def lstm_f32_forward_chain(xw, whs, reverse=False, with_cs=False,
                           batch=None, rows=None):
    """The recurrence on the card -> (y [B, T, dirs * H] f32, cs [B, T,
    dirs * H] f32 or None). xw in the chain's order from `lstm_f32_project`
    (its batch given as `batch`, its rows a cluster read from its shape),
    or [dirs, B, T, 4H] (the two-kernel layers; `batch` None, the rows a
    cluster `rows` or, if None, from `rows_per_cluster`); whs one [H, 4H]
    f32 per direction, contiguous."""
    hidden = whs[0].shape[0]
    h4 = 4 * hidden
    dirs, t_len = xw.shape[0], xw.shape[2]
    chain_order = batch is not None
    if chain_order:
        rows = xw.shape[3] // h4
    else:
        batch = xw.shape[1]
        if rows is None:
            rows = rows_per_cluster(batch, dirs, hidden, xw.device.index)
    y = torch.empty(batch, t_len, dirs * hidden, dtype=torch.float32,
                    device=xw.device)
    cs = torch.empty_like(y) if with_cs else None
    wh_f, wh_b = _pair(whs)
    _launch(lstm_f32_forward_chain,
            _entry("lstm_forward_f32", "lstm_f32_forward", 5, 7),
            (xw, wh_f, wh_b, y, cs),
            (batch, t_len, hidden, dirs, int(reverse), int(chain_order),
             rows), xw.device)
    return y, cs


for _fn in (lstm_f32_project, lstm_f32_forward_chain):
    _fn.launches = 0


def from_f32_chain_order(xw, batch, hidden):
    """xw in the chain's order -> [dirs, B, T, 4H] (the inverse of the
    layout F32ChainXw of csrc/lstm_forward_f32.cu: per tile of rows and
    step, [rank][row][unit j][gate q])."""
    dirs, tiles, t_len, n = xw.shape
    ranks = hidden // _UNITS
    rows = n // (4 * hidden)
    v = xw.view(dirs, tiles, t_len, ranks, rows, _UNITS, 4)
    # rows (tile, row); columns (gate, rank, unit j)
    v = v.permute(0, 1, 4, 2, 6, 3, 5)
    return v.reshape(dirs, tiles * rows, t_len, 4 * hidden)[:, :batch]


# ---- plain versions -----------------------------------------------------------


def lstm_f32_project_reference(x, wxs, biases, spec, t_len):
    """Plain version of `lstm_f32_project`, in the layers' order [dirs, B,
    T, 4H]: f32 sums of the x part of A and Wx, plus the bias."""
    from wesep_tpu_torch.ops.cuda_lstm_tc import x_rows

    xs = x_rows(x, spec, t_len)
    return torch.stack([torch.matmul(xs, w.float()) + b.float()
                        for w, b in zip(wxs, biases)])


def _walks_back(d: int, dirs: int, reverse: bool) -> bool:
    return (dirs == 2 and d == 1) != bool(reverse)


def lstm_f32_forward_chain_reference(xw, whs, reverse=False, with_cs=False):
    """Plain version of `lstm_f32_forward_chain`, step by step with the
    kernel's partition of the sums: each gate g = xw + the partial sums of
    h_{t-1} @ Wh over k in [w H / 8, (w + 1) H / 8), added in w order (the
    8 warps of a block; which block owns a column does not change its
    sums), then the activations and c, all in f32. xw [dirs, B, T, 4H] ->
    (y [B, T, dirs * H] f32, cs [B, T, dirs * H] f32 or None)."""
    dirs, batch, t_len, h4 = xw.shape
    hidden = h4 // 4
    kw = hidden // _WARPS
    parts = [slice(k, k + kw) for k in range(0, hidden, kw)]
    ys, cs = [], []
    for d in range(dirs):
        wh = whs[d].float()
        h = xw.new_zeros(batch, hidden, dtype=torch.float32)
        c = torch.zeros_like(h)
        y_d, c_d = [None] * t_len, [None] * t_len
        steps = range(t_len - 1, -1, -1) if _walks_back(d, dirs, reverse) \
            else range(t_len)
        for t in steps:
            g = xw[d, :, t].float()
            for k in parts:
                g = g + torch.matmul(h[:, k], wh[k])
            i, f, gg, o = g.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            y_d[t], c_d[t] = h, c
        ys.append(torch.stack(y_d, dim=1))
        cs.append(torch.stack(c_d, dim=1))
    return torch.cat(ys, dim=-1), (torch.cat(cs, dim=-1) if with_cs else None)


# ---- the composition ----------------------------------------------------------


def split_forward_f32(x, spec, wxs, biases, whs, xw=None, t_len=None,
                      reverse=False, with_cs=False, plain=False):
    """The f32 forward as the card runs it: the projection (unless xw is
    given) and the recurrence, from the kernels or (`plain`) their plain
    versions; arguments and results as `cuda_lstm_tc.split_forward`, all
    f32."""
    if plain:
        if xw is None:
            xw = lstm_f32_project_reference(x, wxs, biases, spec, t_len)
        return lstm_f32_forward_chain_reference(xw, whs, reverse, with_cs)
    if xw is not None:
        return lstm_f32_forward_chain(xw, whs, reverse, with_cs)
    batch, hidden = x.shape[0], whs[0].shape[0]
    rows = rows_per_cluster(batch, len(whs), hidden, x.device.index)
    xw = lstm_f32_project(x, wxs, biases, spec, t_len, rows)
    return lstm_f32_forward_chain(xw, whs, reverse, with_cs, batch=batch)
