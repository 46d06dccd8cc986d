"""bin/export in the port.

bin/export of BSRNN, SpEx+ (ConvTasNet), TF-GridNet on the unfold route
(WESEP_LSTM_UNFOLD=1) and DPCCN on conv_impl "pallas": the loaded .pt2
gives the eager forward's output bit for bit on the CPU, and its graph
holds one `wesep::` operator node for every kernel call the eager forward
makes (counted by wrapping the operators), with no plain LSTM, TCN block or
fused Conv2dBlock in their place; export.json has the JAX package's
manifest keys (tests/test_torch_runtime_host.py holds them against the JAX
export's). The two-kernel layers' operators (the pBSRNN's other LSTM
routes) are exported as layers.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from test_torch_infer import MODEL_ARGS as V1_ARGS
from wesep_tpu_torch.bin import export as port_export
from wesep_tpu_torch.bin.export import ServedForward, export_model
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.ops import (
    cuda_conv2d,
    cuda_lstm,
    cuda_lstm_fused,
    cuda_lstm_unfold,
    cuda_tcn,
)
from wesep_tpu_torch.train.checkpoint import save_checkpoint, split_state

torch.set_num_threads(1)  # one intra-op thread per test worker

# model -> (name, arguments, samples, environment, the operator it runs)
CASES = {
    "bsrnn": ("BSRNN", dict(V1_ARGS, num_repeat=1), 4000, {},
              "bilstm_layer"),
    "spex": ("ConvTasNet", dict(
        N=16, L=20, B=16, H=32, P=3, X=2, R=2, spk_emb_dim=16, norm="gLN",
        causal=False, skip_con=False, spk_fuse_type="concatConv",
        multi_fuse=True, encoder_type="Multi", decoder_type="Multi",
        joint_training=False), 1600, {}, "tcn_block_gln"),
    "tfgridnet": ("TFGridNet", dict(
        n_fft=32, stride=16, n_layers=2, lstm_hidden_units=16,
        attn_n_head=2, attn_approx_qk_dim=32, emb_dim=8, emb_ks=4, emb_hs=1,
        spk_emb_dim=16, spk_fuse_type="multiply", joint_training=False),
        800, {"WESEP_LSTM_UNFOLD": "1"}, "bilstm_layer_unfold"),
    "dpccn": ("DPCCN", dict(spk_emb_dim=16, win=512, stride=128,
                            joint_training=False, tcn_layers=1, tcn_blocks=2,
                            conv_impl="pallas"), 4000, {},
              "conv2d_block_in"),
}
# each operator's Python entry, wrapped to count the eager forward's calls
OPS = {"bilstm_layer": (cuda_lstm, "bilstm_layer_op"),
       "bilstm_fused": (cuda_lstm_fused, "bilstm_fused_op"),
       "lstm_fused": (cuda_lstm_fused, "lstm_fused_op"),
       "bilstm_layer_unfold": (cuda_lstm_unfold, "bilstm_layer_unfold_op"),
       "tcn_block_gln": (cuda_tcn, "tcn_block_gln_op"),
       "conv2d_block_in": (cuda_conv2d, "conv2d_block_in_op")}
JAX_MANIFEST_KEYS = {"model", "mix_shape", "enroll_shape", "speaker_feat",
                     "joint_training", "sample_rate", "platforms"}


def _model_dir(root, name, args, seed=0):
    """A port bundle of the seeded model and its config.yaml."""
    torch.manual_seed(seed)
    model = get_model(name)(**args)
    params, buffers = split_state(model)
    os.makedirs(root, exist_ok=True)
    save_checkpoint(os.path.join(root, "avg_model.ckpt"), [params],
                    batch_stats=[buffers])
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": {"tse_model": name},
                        "model_args": {"tse_model": args},
                        "dataset_args": {"resample_rate": 16000}}, f)
    return model


def _count_calls(monkeypatch):
    calls = {}
    for op, (module, attr) in OPS.items():
        fn = getattr(module, attr)

        def counted(*a, _fn=fn, _op=op):
            calls[_op] = calls.get(_op, 0) + 1
            return _fn(*a)

        monkeypatch.setattr(module, attr, counted)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_holds_the_operators_and_reloads_bit_for_bit(
        tmp_path, monkeypatch, case):
    name, args, samples, env, op = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    root = str(tmp_path / "mdl")
    model = _model_dir(root, name, args)
    out, program = export_model(os.path.join(root, "config.yaml"),
                                os.path.join(root, "avg_model.ckpt"),
                                str(tmp_path / "export"), batch=2,
                                samples=samples, device="cpu")
    with open(os.path.join(out, "export.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == JAX_MANIFEST_KEYS
    assert manifest["mix_shape"] == [2, samples]
    assert manifest["enroll_shape"] == [2, args["spk_emb_dim"]]
    assert manifest["platforms"] == ["cpu"]

    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    nodes = {o: targets.count(f"wesep.{o}.default") for o in OPS}
    assert not any("lstm" in t and not t.startswith("wesep.")
                   for t in targets), targets
    rng = np.random.default_rng(1)
    mix = torch.from_numpy(
        (0.1 * rng.standard_normal((2, samples))).astype(np.float32))
    enroll = torch.from_numpy(
        rng.standard_normal((2, args["spk_emb_dim"])).astype(np.float32))
    served = ServedForward(model.eval())
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        want = served(mix, enroll)
    monkeypatch.undo()
    assert calls and set(calls) == {op}
    assert nodes == {o: calls.get(o, 0) for o in OPS}
    assert calls[op] >= 2
    got = port_export.load_program(out)(mix, enroll)
    assert torch.equal(got, want)


def test_export_refuses_savedmodel(tmp_path):
    root = str(tmp_path / "mdl")
    _model_dir(root, "BSRNN", dict(V1_ARGS, num_repeat=1))
    with pytest.raises(NotImplementedError, match="SavedModel"):
        export_model(os.path.join(root, "config.yaml"),
                     os.path.join(root, "avg_model.ckpt"),
                     str(tmp_path / "x"), fmt="savedmodel", device="cpu")


class _TwoKernelLayers(torch.nn.Module):
    """The two-kernel bidirectional layer, then the unidirectional one
    (reversed), over explicit weights."""

    def __init__(self, d=8, h=16, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)

        def w(*shape):
            return torch.nn.Parameter(0.3 * torch.randn(*shape,
                                                        generator=gen))

        self.bi = torch.nn.ParameterList(
            [w(d, 4 * h), w(4 * h), w(h, 4 * h),  # forward direction
             w(d, 4 * h), w(4 * h), w(h, 4 * h)])  # backward direction
        self.uni = torch.nn.ParameterList([w(2 * h, 4 * h), w(4 * h),
                                           w(h, 4 * h)])

    def forward(self, x):
        y = cuda_lstm_fused.bilstm_fused(x, *self.bi)
        return cuda_lstm_fused.lstm_fused(y, *self.uni, reverse=True)


def test_export_holds_the_two_kernel_operators():
    module = _TwoKernelLayers().eval().requires_grad_(False)
    x = torch.randn(3, 7, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = module(x)
        program = torch.export.export(module, (x,))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("wesep.bilstm_fused.default") == 1
    assert targets.count("wesep.lstm_fused.default") == 1
    assert torch.equal(program.module()(x), want)
