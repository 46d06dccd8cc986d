"""The tensor-core TCN kernels' host side, on the CPU: what the wrappers
plan from the shapes (rows per split of the weight gradients, scratch of
each pass), what they pass to the C entry points, and that every ctypes
declaration matches its entry point in csrc/, parsed from the source (the
card would refuse another count only there)."""

import ctypes
import math
import os
import re

import numpy as np
import pytest
import torch

from wesep_tpu_torch.ops import cuda_tcn as k

torch.set_num_threads(1)  # one intra-op thread per test worker

CSRC = os.path.join(os.path.dirname(k.__file__), os.pardir, "csrc")
# SpEx+'s fused block: C 256, H 512, k 3, T 4799 encoder frames of 3 s
SPEX = dict(t_len=4799, c=256, h=512, k=3)
KINDS = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
         ctypes.c_longlong: "long long", ctypes.c_float: "float"}


def _source(library):
    with open(os.path.join(CSRC, library + ".cu")) as f:
        return f.read()


def _c_kinds(library, entry):
    """The kinds of a C entry point's parameters, in order."""
    found = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{",
                      _source(library), re.S)
    kinds = []
    for param in (p.strip() for p in found.group(1).split(",")):
        kind = "ptr" if "*" in param else " ".join(param.split()[:-1])
        assert kind in KINDS.values(), (entry, param)
        kinds.append(kind)
    return kinds


@pytest.mark.parametrize("library,entry", [("tcn_block", "tcn_block_forward"),
                                           ("tcn_block_bwd",
                                            "tcn_block_backward")])
def test_ctypes_declarations_match_the_c_entry_points(library, entry):
    declared = [KINDS[t] for t in k._argtypes(entry)]
    assert declared == _c_kinds(library, entry)


def _args(batch, t_len, c=16, h=24, kk=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return [f(batch, t_len, c), f(batch, h), f(c, h), torch.tensor([0.25]),
            f(kk, h), f(h), f(h), f(h), torch.tensor([0.2]), f(h, c), f(c),
            f(h), f(h)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_pass_what_the_entry_points_declare(monkeypatch, dtype):
    """Each pass hands its entry point as many pointers (the events
    handles among them) and ints, longs and floats as it declares, and
    scratch of the planned size; the launches are counted by `_launch`."""
    calls = []

    class Lib:
        tcn_block_forward = "tcn_block_forward"
        tcn_block_backward = "tcn_block_backward"

    monkeypatch.setattr(k, "_library", lambda name: Lib)
    monkeypatch.setattr(k, "_launch", lambda counter, fn, tensors, ints,
                        device: calls.append((fn, tensors, ints)))
    batch, t_len, c, h, kk, dilation = 3, 301, 16, 24, 3, 4
    args = _args(batch, t_len, c, h, kk)
    args[0] = args[0].to(dtype)
    conf = (dilation, kk, False, 1e-5)
    events = torch.zeros(len(k.FORWARD_LAUNCHES), dtype=torch.int64)
    k._forward_cuda(*args, *conf, events=events)
    stats = torch.zeros(batch, 4)
    k.tcn_block_gln_backward(*args, stats, torch.zeros_like(args[0]), *conf)
    assert [fn for fn, _, _ in calls] == ["tcn_block_forward",
                                          "tcn_block_backward"]
    plans = {"tcn_block_forward": k.forward_plan(batch, t_len, c, h),
             "tcn_block_backward": k.backward_plan(batch, t_len, c, h, kk)}
    for fn, tensors, ints in calls:
        kinds = _c_kinds("tcn_block" if fn == "tcn_block_forward"
                         else "tcn_block_bwd", fn)
        assert kinds[-1] == "ptr"  # the stream, which _launch appends
        assert len(tensors) == kinds.count("ptr") - 1, fn
        passed = ["float" if isinstance(v, float) else "int" for v in ints]
        assert [("int" if kd == "long long" else kd)
                for kd in kinds[len(tensors):-1]] == passed, fn
        stream_ws, f32_ws, ev = tensors[-3:]
        *_, n_stream, n_f32 = plans[fn]
        assert stream_ws.numel() == n_stream and stream_ws.dtype == dtype
        assert f32_ws.numel() == n_f32 and f32_ws.dtype == torch.float32
        # the plan's sizes and the events' count go to the entry point
        longs = [v for v, kd in zip(ints, kinds[len(tensors):-1])
                 if kd == "long long"]
        assert longs[-2:] == [n_stream, n_f32], fn
        if fn == "tcn_block_forward":
            assert ev is events and ints[8] == len(events)
        else:
            assert ev is None and ints[8] == 0
            assert longs[0] == plans[fn][0]  # rows per split


@pytest.mark.parametrize("rows,c,h", [
    (1, 8, 8), (31, 8, 8), (512, 256, 512), (2 * 4799, 256, 512),
    (16 * 4799, 256, 512), (65537 * 16, 8, 8), (65536 * 128 + 5, 8, 8),
    (3 * 301, 40, 72), (1, 256, 512)])
def test_wgrad_splits_fill_the_card_and_cover_the_rows(rows, c, h):
    """Rows per split: a multiple of 32 (a stage's depth), no split empty,
    at most two blocks an SM of 132 beyond one wave of tiles, no more
    splits than runs of 512 rows, within the grid's 65535."""
    per = k.wgrad_rows(rows, c, h)
    splits = math.ceil(rows / per)
    tiles = math.ceil(c / 128) * math.ceil(h / 128)
    assert per % 32 == 0 and per >= 32
    assert (splits - 1) * per < rows <= splits * per
    assert splits <= max(1, math.ceil(264 / tiles)) and splits <= 65535
    assert splits <= math.ceil(rows / 512)


def test_plans_at_spex_shapes():
    """The numbers the card is given at SpEx+'s serving (B 2) and training
    (B 16) shapes: 38 chunks of 128 frames (75 of 64, the f32 short tiles)
    by 4 tiles of 128 channels of H; 19 and 33 splits of the weight
    gradients (8 tiles of [C, H] each)."""
    t, c, h, kk = SPEX["t_len"], SPEX["c"], SPEX["h"], SPEX["k"]
    assert k.forward_plan(2, t, c, h) == (2 * 2 * t * h,
                                          4 * 2 * (75 * 4 + 38 * 4) + 2 * c)
    assert k.wgrad_rows(2 * t, c, h) == 512
    assert k.wgrad_rows(16 * t, c, h) == 2336
    per, n_stream, n_f32 = k.backward_plan(16, t, c, h, kk)
    assert (per, n_stream) == (2336, 3 * 16 * t * h)
    # scalar partials and per-sample sums in f64, two floats each
    assert n_f32 == (4 * 16 * 38 * 4 + 8 * 16 + 16 * 38 * (1 + kk) * h
                     + 33 * h * c)
    # the backward's f32 scratch no longer holds s and dn1 ([B, T, H] each)
    assert n_f32 < 16 * t * h


@pytest.mark.parametrize("batch,t_len,c,h,kk", [
    (1, 1, 8, 8, 1), (1, 5, 8, 16, 8), (65535, 16, 8, 8, 3),
    (1, 65536 * 128 + 5, 8, 8, 3), (3, 301, 40, 72, 3)])
def test_plans_cover_every_shape_the_gate_takes(batch, t_len, c, h, kk):
    """kernel_fits is the one gate: every shape it takes, at any B a
    launch takes and any T, gets a plan whose f32 scratch holds the
    widest per-channel partials (db2's C or (1 + k) H per chunk)."""
    assert k.kernel_fits(c, h, kk)
    n_stream, n_f32 = k.forward_plan(batch, t_len, c, h)
    assert n_stream == 2 * batch * t_len * h and n_f32 > batch * c
    per, n_stream, n_f32 = k.backward_plan(batch, t_len, c, h, kk)
    chunks = batch * math.ceil(t_len / 128)
    assert n_stream == 3 * batch * t_len * h
    assert n_f32 >= chunks * max((1 + kk) * h, c) + 8 * batch
    assert math.ceil(batch * t_len / per) <= 65535


def _marks(body):
    """Launches a C pass marks: its marks but the start."""
    return body.count("mk.done(") - body.count("mk.done(cudaSuccess")


def test_launch_names_follow_the_entry_points():
    """FORWARD_LAUNCHES and BACKWARD_LAUNCHES name one launch each, as
    many as the C passes mark after the start (each weight gradient marks
    its product and its sum)."""
    fwd = _source("tcn_block")
    body = fwd[fwd.index("cudaError_t forward("):fwd.index("}  // namespace")]
    assert body.count("mk.done(cudaSuccess") == 1
    assert _marks(body) == len(k.FORWARD_LAUNCHES) == 6
    bwd = _source("tcn_block_bwd")
    body = bwd[bwd.index("cudaError_t backward("):
               bwd.index("}  // namespace")]
    wgrad = bwd[bwd.index("cudaError_t wgrad("):bwd.index("struct Layout")]
    assert body.count("mk.done(cudaSuccess") == 1
    assert _marks(body) + body.count("wgrad<T>(") * _marks(wgrad) \
        == len(k.BACKWARD_LAUNCHES)
    assert k.BACKWARD_LAUNCHES.count("dW2 product") == 1
