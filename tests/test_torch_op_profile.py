"""tools/op_profile and tools/trace_step in the port.

A hand-built Chrome trace (torch.profiler's layout) gives op_profile's exact
table: class sums, the port's kernels by name with launch counts, the busy
ms (the union of the device's events, two streams overlapping) and the
window's; trace_step --device cpu traces a narrow pBSRNN's train step and
op_profile prints its no-device line; the port's envelopes are
tools/bench_models.ENVELOPES'.
"""

import glob
import json
import os
import re

import pytest
import torch

from wesep_tpu_torch.tools import op_profile, trace_step

torch.set_num_threads(1)  # one intra-op thread per test worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
            "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": stream}}


TRACE = {
    "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
    "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 1000.0, "dur": 500.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 1100.0, "dur": 10.0},
        kernel("void (anonymous namespace)::tc_product_kernel<3, 0>"
               "(Rows, Operands)", 1200.0, 250.0),
        kernel("void (anonymous namespace)::tc_product_kernel<3, 0>"
               "(Rows, Operands)", 1500.0, 250.0),
        kernel("void lstm_forward_chain_kernel<6, float>(FwdArgs<float>)",
               1750.0, 1000.0),
        # a second stream overlapping the chain by 500 us
        kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
               2250.0, 750.0, stream=13),
        kernel("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, "
               "512, true, 1>(cudnnTensorStruct)", 3000.0, 125.0),
        kernel("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::FillFunctor<float>, at::detail::Array<char*, 1> >"
               "(int, at::native::FillFunctor<float>, "
               "at::detail::Array<char*, 1>)", 3125.0, 62.5),
        kernel("void regular_fft<512u, 4u>(fft_params)", 3187.5, 62.5),
        kernel("some_unknown_kernel", 3250.0, 125.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pinned)", "pid": 0, "tid": 7, "ts": 3375.0, "dur": 125.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 5000.0, "dur": 250.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "pid": 1,
         "tid": 1, "ts": 3000.0, "dur": 3000.0},
    ],
}

EXPECTED = """\
NVIDIA H100 80GB HBM3: device busy 2.5 ms, window 5.0 ms (50.0 % busy)
       1.50 ms  50.0%  the port's kernels
       0.75 ms  25.0%  cuBLAS / CUTLASS products
       0.38 ms  12.5%  copies and sets
       0.12 ms   4.2%  cuDNN
       0.12 ms   4.2%  other kernels
       0.06 ms   2.1%  torch elementwise and reductions
       0.06 ms   2.1%  cuFFT
       1.00 ms  33.3%    lstm_forward_chain_kernel<6, float> x1
       0.50 ms  16.7%    tc_product_kernel<3, 0> x2
"""


def test_op_profile_of_a_hand_built_trace(tmp_path, capsys):
    path = tmp_path / "trace_1_2.json"
    path.write_text(json.dumps(TRACE))
    prof = op_profile.profile(op_profile.load_trace(str(tmp_path)))
    assert prof["window_ms"] == 5.0  # 1000 us to 6000 us
    # 1200-3500 us but the 500 us the streams share, and the memset
    assert prof["busy_ms"] == 2.5
    assert prof["event_ms"] == 3.0
    assert prof["kernels"] == {"tc_product_kernel<3, 0>": [0.5, 2],
                               "lstm_forward_chain_kernel<6, float>":
                               [1.0, 1]}
    assert prof["classes"] == {
        op_profile.PORT: 1.5, "cuBLAS / CUTLASS products": 0.75,
        "cuDNN": 0.125, "torch elementwise and reductions": 0.0625,
        "cuFFT": 0.0625, op_profile.OTHER: 0.125, op_profile.COPIES: 0.375}
    op_profile.main([str(tmp_path), "--top", "5"])
    assert capsys.readouterr().out == EXPECTED
    op_profile.main([str(path), "--top", "1"])
    assert capsys.readouterr().out == "".join(
        EXPECTED.splitlines(True)[:-1])


def test_op_profile_without_a_trace_or_device_events(tmp_path, capsys):
    op_profile.main([str(tmp_path)])
    assert capsys.readouterr().out == \
        f"no Chrome trace found under {tmp_path}\n"
    cpu_only = dict(TRACE, traceEvents=[
        e for e in TRACE["traceEvents"]
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset")])
    (tmp_path / "t.json").write_text(json.dumps(cpu_only))
    op_profile.main([str(tmp_path)])
    assert capsys.readouterr().out == \
        "no device events in the trace (5.0 ms window): a CPU run\n"


def test_the_ports_kernels_are_every_global_function():
    """Each `__global__` function of csrc/ once, by name."""
    text = "".join(open(p).read() for p in sorted(glob.glob(
        os.path.join(REPO, "wesep_tpu_torch", "csrc", "*.cu*"))))
    names = op_profile.port_kernel_names()
    assert len(names) == len(re.findall(r"__global__\b", text))
    for name in ("tc_product_kernel", "lstm_chain_kernel",
                 "lstm_forward_chain_kernel", "f32_chain_kernel",
                 "f32_adjoint_kernel", "tcn_dn0_kernel", "conv_tc_kernel"):
        assert name in names
    assert op_profile.kernel_label(
        "void f32_chain_kernel<8, 2>(ChainArgs)") == "f32_chain_kernel<8, 2>"


def test_trace_step_on_the_cpu_then_op_profile(tmp_path, capsys,
                                               monkeypatch):
    # a narrow pBSRNN, 2 rows x 0.25 s
    env = trace_step.ENVELOPES["bsrnn"]
    monkeypatch.setitem(trace_step.ENVELOPES, "bsrnn", dict(
        env, args=dict(env["args"], feature_dim=8, num_repeat=1), batch=2))
    monkeypatch.setattr(trace_step, "CHUNK_SEC", 0.25)
    out = str(tmp_path / "trace")
    trace_step.main(["--model", "bsrnn", "--out", out, "--steps", "1",
                     "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"python -m wesep_tpu_torch.tools.op_profile {out}" in printed
    (path,) = glob.glob(os.path.join(out, "*.json"))
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    op_profile.main([out])
    assert re.fullmatch(r"no device events in the trace \(\d+\.\d ms "
                        r"window\): a CPU run\n", capsys.readouterr().out)


def test_trace_step_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="none is available"):
        trace_step.trace_step("bsrnn", "unused")


def test_the_envelopes_are_bench_models():
    from tools.bench_models import CHUNK_SEC, ENVELOPES, SR

    assert list(trace_step.ENVELOPES) == list(ENVELOPES)[:6]
    for name, env in trace_step.ENVELOPES.items():
        assert env == ENVELOPES[name], name
    assert (trace_step.CHUNK_SEC, trace_step.SR) == (CHUNK_SEC, SR)
