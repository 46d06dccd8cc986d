"""The fused Conv2dBlock kernels' host side, on the CPU: how the passes
tile the positions, how the backward's dK pass shares the tiles out over a
wave of blocks, the scratch each pass is given, what the wrappers pass to
the C entry points, and that every ctypes declaration matches its entry
point in csrc/, parsed from the source (the card would refuse another count
only there)."""

import ctypes
import math
import os
import re

import numpy as np
import pytest
import torch

from wesep_tpu_torch.ops import cuda_conv2d as k
from wesep_tpu_torch.ops.cuda_tcn import batch_chunks

torch.set_num_threads(1)  # one intra-op thread per test worker

CSRC = os.path.join(os.path.dirname(k.__file__), os.pardir, "csrc")
KINDS = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
         ctypes.c_longlong: "long long", ctypes.c_float: "float"}
T = 376  # frames of a 3 s chunk
# DPCCN's gated blocks (F, Ci, Co): enc0.conv1, enc0.conv2 (= dec7.conv1),
# enc1-4_dense.conv1
DPCCN = [(257, 16, 16), (257, 32, 16), (129, 32, 32), (65, 32, 32),
         (33, 32, 32), (17, 32, 32)]
# ragged ones: T 1, F 1, one tile's worth, less than a tile, Ci 16 and 24,
# Co 8 and 48, T * F a multiple of 128
RAGGED = [(1, 1, 300, 16, 16), (2, 200, 1, 16, 8), (2, 64, 2, 24, 16),
          (1, 7, 17, 32, 32), (9, 11, 13, 8, 24), (3, 130, 65, 48, 48),
          (1, 1, 1, 8, 8)]
DTYPES = [torch.float32, torch.bfloat16]


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _c_kinds(library, entry, ret="int"):
    """The kinds of a C entry point's parameters, in order."""
    found = re.search(r'extern "C" ' + ret + " " + entry
                      + r"\((.*?)\)\s*\{", _source(library + ".cu"), re.S)
    kinds = []
    for param in (p.strip() for p in found.group(1).split(",")):
        kind = "ptr" if "*" in param else " ".join(param.split()[:-1])
        assert kind in KINDS.values(), (entry, param)
        kinds.append(kind)
    return kinds


def _constant(name, source):
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         _source(source)).group(1))


@pytest.mark.parametrize("library,entry", [
    ("conv2d_block", "conv2d_block_forward"),
    ("conv2d_block_bwd", "conv2d_block_backward"),
    ("conv2d_block_bwd", "conv2d_block_backward_slots")])
def test_ctypes_declarations_match_the_c_entry_points(library, entry):
    declared = [KINDS[t] for t in k._argtypes(entry)]
    assert declared == _c_kinds(library, entry)


@pytest.mark.parametrize("library,entry,n_ints", [
    ("conv2d_block", "conv2d_block_forward_scratch", 6),
    ("conv2d_block_bwd", "conv2d_block_backward_scratch", 7)])
def test_scratch_queries_take_the_shapes_and_two_sizes(library, entry,
                                                       n_ints):
    """B, T, F, Ci, Co, dtype (and the dK blocks) in, the two sizes out."""
    assert _c_kinds(library, entry, ret="void") == ["int"] * n_ints \
        + ["ptr"] * 2


def test_tile_constants_follow_the_sources():
    """The Python plans use the C sources' tile sizes."""
    assert k._TC_TILE == _constant("kM", "conv2d_tc.cuh")
    assert k._TC_WARPS == _constant("kTcWarps", "conv2d_tc.cuh")
    assert k._F32_COLS == _constant("kTF", "conv2d_common.cuh")
    assert k._F32_DK_ROWS == _constant("kKTT", "conv2d_block_bwd.cu")
    assert k._F32_DOUT_CHUNK == _constant("kChunk", "conv2d_block_bwd.cu")
    assert _constant("kKBlocks", "conv2d_block_bwd.cu") == 256
    assert _constant("kMaxC", "conv2d_common.cuh") == k.MAX_CHANNELS


def _bf16_tile_of(t_len, f_len):
    """Tile (within the sample) of every position (t, f): 128 consecutive
    positions t * F + f each."""
    p = np.arange(t_len * f_len).reshape(t_len, f_len)
    return p // k._TC_TILE


def _f32_tile_of(t_len, f_len, co):
    """Tile of every position of the f32 conv kernel: 16, 8 or 4 rows by
    32 columns, row-major over T tiles x F tiles."""
    rows = 16 if co <= 16 else 8 if co <= 32 else 4
    t = np.arange(t_len)[:, None] // rows
    f = np.arange(f_len)[None, :] // k._F32_COLS
    return t * math.ceil(f_len / k._F32_COLS) + f


@pytest.mark.parametrize("batch,t_len,f_len,ci,co",
                         [(8, T, f, ci, co) for f, ci, co in DPCCN] + RAGGED)
def test_tiles_cover_every_position_exactly_once(batch, t_len, f_len, ci,
                                                 co):
    """Each pass's tiles, numbered b * tiles + tile as the kernels walk
    them, cover every (b, t, f) once; none is empty; the count is what the
    plans size the per-tile sums by. A tile of the bf16 passes wastes only
    the last tile's tail of a sample."""
    del ci
    for tile_of, n in ((_bf16_tile_of(t_len, f_len),
                        k._tc_tiles(t_len, f_len)),
                       (_f32_tile_of(t_len, f_len, co),
                        k._f32_conv_tiles(t_len, f_len, co))):
        ids = (np.arange(batch)[:, None, None] * n + tile_of[None]).ravel()
        counts = np.bincount(ids, minlength=batch * n)
        assert counts.size == batch * n and (counts > 0).all()
        assert counts.sum() == batch * t_len * f_len
    waste = k._tc_tiles(t_len, f_len) * k._TC_TILE - t_len * f_len
    assert 0 <= waste < k._TC_TILE


def test_bf16_tiles_waste_no_lanes_at_dpccn_widths():
    """At T 376 the 128-position tiles leave at most 120 positions of a
    sample unused (F 257: 8 of 96,640); the f32 kernel's 32-column tiles
    leave 31 of every 288 columns at F 257 and 15 of 32 at F 17."""
    for f, _, _ in DPCCN:
        n = k._tc_tiles(T, f)
        assert n * 128 - T * f < 128
    assert k._tc_tiles(T, 257) * 128 - T * 257 == 8


@pytest.mark.parametrize("batch", [1, 65535, 65537])
def test_tiles_of_a_batch_past_one_grid_dimension(batch):
    """A batch over 65535 runs as slices; the slices' tiles together cover
    the batch once (the per-sample sums never cross a slice)."""
    t_len, f_len = 4, 4
    n = k._tc_tiles(t_len, f_len)
    covered = 0
    for b0, b1 in batch_chunks(batch):
        assert 0 < b1 - b0 <= 65535
        covered += (b1 - b0) * n * k._TC_TILE
        assert k.dk_units(b1 - b0, t_len, f_len, torch.bfloat16) \
            == (b1 - b0) * n
    assert covered >= batch * t_len * f_len


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("slots", [1, 132, 264, 396, 10 ** 6])
@pytest.mark.parametrize("batch,t_len,f_len,ci,co",
                         [(8, T, f, ci, co) for f, ci, co in DPCCN]
                         + [(2, T, 257, 32, 16)] + RAGGED)
def test_dk_split_gives_every_tile_to_one_block_in_one_wave(
        dtype, slots, batch, t_len, f_len, ci, co):
    """The dK blocks: at most what one wave holds (the grid's chunks of
    input and slabs of output channels counted), at most one a tile, at
    least one; block g walks g, g + G, ..., so every tile has one block
    and every block a tile."""
    units = k.dk_units(batch, t_len, f_len, dtype)
    blocks = k.dk_blocks(units, ci, co, dtype, slots)
    per = 1 if dtype == torch.float32 else \
        math.ceil(ci / (16 if ci <= 16 else 32)) \
        * math.ceil(co / (16 if co <= 16 else 32))
    assert 1 <= blocks <= units
    assert blocks * per <= max(slots, per)
    if units * per >= slots >= per:
        assert blocks == slots // per  # the wave is filled
    owner = np.full(units, -1)
    for g in range(blocks):
        tiles = list(range(g, units, blocks))  # the C pass's walk
        assert tiles, g
        assert (owner[tiles] == -1).all()
        owner[tiles] = g
    assert (owner >= 0).all()


def test_plans_at_dpccn_shapes():
    """The numbers the card is given at the six shapes: f32 B 2 keeps e
    [B, T, F, Co] and the f32 partials; bf16 B 8 keeps no f32 stream, only
    f64 partials (two floats each) and, in the backward, dK per block; the
    stream scratch of the backward is dout."""
    slots = 264
    for f, ci, co in DPCCN:
        pos = T * f
        n16 = k._tc_tiles(T, f)
        # f64 sums (two floats) of each of a tile's 4 warps
        assert k.forward_plan(8, T, f, ci, co, torch.bfloat16) \
            == (0, 2 * 2 * 8 * n16 * 4 * co)
        assert k.forward_plan(2, T, f, ci, co, torch.float32) \
            == (0, 2 * pos * co + 2 * 2 * k._f32_conv_tiles(T, f, co) * co)
        blocks, n_stream, n_f32 = k.backward_plan(8, T, f, ci, co,
                                                  torch.bfloat16, slots)
        assert blocks == 264 and n_stream == 8 * pos * co
        assert n_f32 == 2 * (2 * 8 * n16 * 4 * co + 2 * 8 * co + 264 * co) \
            + 9 * 264 * ci * co
        # no f32 [B, T, F, Co] stream beside the dK partials
        assert n_f32 - 9 * 264 * ci * co < 8 * pos * co
        blocks, n_stream, n_f32 = k.backward_plan(2, T, f, ci, co,
                                                  torch.float32, 256)
        # 4 x 32 tiles: 2 x 94 x 1 = 188 at F 17
        assert blocks == min(256, 2 * 94 * math.ceil(f / 32))
        assert n_stream == 2 * pos * co
        assert n_f32 >= 2 * pos * co + 9 * blocks * ci * co
    # enc0.conv2: 755 tiles of 128 a sample, 6040 at B 8
    assert k.dk_units(8, T, 257, torch.bfloat16) == 6040


def test_f64_sections_keep_their_alignment():
    """The bf16 scratch starts with its f64 sections, each a whole number
    of doubles (an even number of floats), so the f32 dK partials after
    them and every f64 section start 8-byte aligned."""
    for batch, t_len, f_len, ci, co in RAGGED:
        blocks, _, n_f32 = k.backward_plan(batch, t_len, f_len, ci, co,
                                           torch.bfloat16, 7)
        f64 = n_f32 - 9 * blocks * ci * co
        assert f64 % 2 == 0 and f64 > 0
        assert k.forward_plan(batch, t_len, f_len, ci, co,
                              torch.bfloat16)[1] % 2 == 0


def _marks(body):
    """Launches a C pass marks: its marks but the start."""
    return body.count("mk.done(") - body.count("mk.done(cudaSuccess")


@pytest.mark.parametrize("dtype", DTYPES)
def test_launch_names_follow_the_entry_points(dtype):
    """FORWARD_LAUNCHES and BACKWARD_LAUNCHES name one launch each, as
    many as each dtype's C pass marks after the start."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    for source, names, fn in (
            ("conv2d_block.cu", k.FORWARD_LAUNCHES, "forward_"),
            ("conv2d_block_bwd.cu", k.BACKWARD_LAUNCHES, "backward_")):
        src = _source(source)
        start = src.index(f"cudaError_t {fn}{tag}(")
        end = src.index("\n}\n", start)
        body = src[start:end]
        assert body.count("mk.done(cudaSuccess") == 1
        assert _marks(body) == len(names[dtype]), (source, tag)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_pass_what_the_entry_points_declare(monkeypatch, dtype):
    """Each pass hands its entry point as many pointers (the events
    handles among them), ints, longs and floats as it declares, scratch of
    the planned size and the planned dK blocks; the launches are counted
    by `_launch`."""
    calls = []

    class Lib:
        conv2d_block_forward = "conv2d_block_forward"
        conv2d_block_backward = "conv2d_block_backward"

    monkeypatch.setattr(k, "_library", lambda name: Lib)
    monkeypatch.setattr(k, "_slots", lambda ci, co, dt, device: 24)
    monkeypatch.setattr(k, "_on_kernel_path", lambda plain, x: True)
    monkeypatch.setattr(k, "_launch", lambda counter, fn, tensors, ints,
                        device: calls.append((fn, tensors, ints)))
    batch, t_len, f_len, ci, co = 3, 41, 29, 24, 48
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, t_len, f_len, ci))
                         .astype(np.float32)).to(dtype)
    w, b = torch.zeros(3, 3, ci, co), torch.zeros(co)
    events = torch.zeros(len(k.FORWARD_LAUNCHES[dtype]) + 1,
                         dtype=torch.int64)
    k._forward_cuda(x, w, b, 1e-5, events=events)
    k.conv2d_block_in_backward(x, w, b, torch.zeros(batch, 2, co),
                               torch.zeros(batch, t_len, f_len, co))
    assert [fn for fn, _, _ in calls] == ["conv2d_block_forward",
                                          "conv2d_block_backward"]
    code = 0 if dtype == torch.float32 else 1
    for fn, tensors, ints in calls:
        kinds = _c_kinds("conv2d_block" if fn == "conv2d_block_forward"
                         else "conv2d_block_bwd", fn)
        assert kinds[-1] == "ptr"  # the stream, which _launch appends
        assert len(tensors) == kinds.count("ptr") - 1, fn
        passed = ["float" if isinstance(v, float) else "int" for v in ints]
        assert [("int" if kd == "long long" else kd)
                for kd in kinds[len(tensors):-1]] == passed, fn
        assert ints[:6] == (batch, t_len, f_len, ci, co, code), fn
        ev = tensors[-1]
        if fn == "conv2d_block_forward":
            _, n_f32 = k.forward_plan(batch, t_len, f_len, ci, co, dtype)
            assert ev is events and ints[6] == len(events)
            assert ints[7] == n_f32 and tensors[5].numel() == n_f32
            assert tensors[5].dtype == torch.float32
        else:
            blocks, n_stream, n_f32 = k.backward_plan(
                batch, t_len, f_len, ci, co, dtype, 24)
            assert ev is None and ints[6] == 0
            assert ints[7:] == (blocks, n_stream, n_f32)
            stream_ws, f32_ws = tensors[9:11]
            assert stream_ws.numel() == n_stream and stream_ws.dtype == dtype
            assert f32_ws.numel() == n_f32
            assert f32_ws.dtype == torch.float32
            # f32: w_flip [3, 3, Co, Ci], w flipped in (T, F) with its
            # channels swapped; bf16 reads w so as it stages it
            w_flip = tensors[2]
            if dtype == torch.float32:
                assert tuple(w_flip.shape) == (3, 3, co, ci)
                assert torch.equal(w_flip, w.flip(0, 1).transpose(2, 3))
            else:
                assert w_flip is None
            assert tensors[1].dtype == torch.float32  # K as stored
