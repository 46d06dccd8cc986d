"""The reference toolkit's PyTorch checkpoints in the port.

For each of the eight families of utils/torch_port.py (BSRNN, BSRNN_Feats,
DPCCN, TF-GridNet, ConvTasNet / SpEx+, and the wespeaker ECAPA, ResNet and
CAM++ encoders of a joint model) a state dict in the reference's layout is
built by hand from a seeded port model's weights
(tests/torch_reference_layouts.py; the reference tree is not in this repo)
and saved as a .pt; then

  * the port's converter brings back the model's state_dict exactly,
    parameters and BatchNorm statistics;
  * the JAX package's converter on the same .pt writes a msgpack bundle
    whose crossing of the weight bridge (port_state_from_jax, through
    train/checkpoint.load_checkpoint) equals the port's bundle exactly;
  * for the v1 BSRNN, the port's bundle decodes through the port's
    bin/infer as the JAX bundle decodes through the JAX bin/infer, within
    5e-4 of the largest output (ROADMAP.md C.1);
  * stack_gridnet_blocks gives the JAX package's scan tree of TF-GridNet.
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_infer import _write_shard
from torch_reference_layouts import reference_state_dict
from wesep_tpu.bin.infer import infer as jax_infer
from wesep_tpu.tools import convert_torch_checkpoint as jax_convert
from wesep_tpu.utils import torch_port as jax_torch_port
from wesep_tpu_torch.bin.infer import infer
from wesep_tpu_torch.data.wav_io import read_wav
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.tools.convert_torch_checkpoint import convert
from wesep_tpu_torch.train.checkpoint import load_checkpoint, model_state
from wesep_tpu_torch.utils import torch_port
from wesep_tpu_torch.utils.jax_params import port_state_from_jax

torch.set_num_threads(1)  # one intra-op thread per test worker

SEP = dict(sr=16000, win=512, stride=128, feature_dim=16, num_repeat=2)
V1_BSRNN = dict(SEP, spk_fuse_type="FiLM", use_spk_transform=True,
                multi_fuse=True, joint_training=False, spk_emb_dim=16)
ECAPA_WS = dict(spk_model="ECAPA_TDNN_GLOB_c32", spk_emb_dim=16,
                spk_args=dict(feat_dim=24, embed_dim=16, pooling_func="ASTP",
                              layout="wespeaker"))
# family -> (model, its arguments, the inverse map's arguments)
CASES = {
    "bsrnn": ("BSRNN", V1_BSRNN,
              dict(family="bsrnn", num_repeat=2, multi_fuse=True,
                   spk_fuse_type="FiLM")),
    # the cross-attention fuse on frame features (an encoder's frame
    # output has no head, which the ECAPA map needs; "ecapa" covers it)
    "bsrnn_feats": ("BSRNN_Feats", dict(
        SEP, use_spk_transform=False, spk_feat=False, feat_type="consistent",
        multi_task=False, spectral_feat=None, spk_fuse_type="cross_multiply",
        multi_fuse=True, joint_training=False, spk_emb_dim=16,
        spk_emb_frame_dim=20),
        dict(family="bsrnn_feats", num_repeat=2, multi_fuse=True,
             spk_fuse_type="cross_multiply")),
    "dpccn": ("DPCCN", dict(spk_emb_dim=16, win=512, stride=128,
                            joint_training=False, tcn_layers=1,
                            tcn_blocks=2), dict(family="dpccn")),
    "tfgridnet": ("TFGridNet", dict(
        n_fft=32, stride=16, n_layers=2, lstm_hidden_units=16,
        attn_n_head=2, attn_approx_qk_dim=32, emb_dim=8, emb_ks=4, emb_hs=1,
        spk_emb_dim=12, spk_fuse_type="multiply", joint_training=False),
        dict(family="tfgridnet")),
    "convtasnet": ("ConvTasNet", dict(
        N=32, L=20, B=32, H=64, P=3, X=3, R=2, spk_emb_dim=16, norm="gLN",
        causal=False, skip_con=False, spk_fuse_type="concatConv",
        multi_fuse=True, encoder_type="Multi", decoder_type="Multi",
        joint_training=False), dict(family="convtasnet")),
    "ecapa": ("BSRNN", dict(
        SEP, spk_fuse_type="multiply", use_spk_transform=False,
        multi_fuse=False, spk_feat=True, joint_training=True, **ECAPA_WS),
        dict(family="bsrnn", num_repeat=2, scope="spk_model_net",
             speaker="ECAPA")),
    "resnet": ("TFGridNet", dict(
        n_fft=32, stride=16, n_layers=1, lstm_hidden_units=16,
        attn_n_head=2, attn_approx_qk_dim=32, emb_dim=8, emb_ks=4, emb_hs=1,
        spk_emb_dim=16, spk_fuse_type="multiply", joint_training=True,
        spk_feat=True, spk_model="ResNet34",
        spk_args=dict(feat_dim=24, m_channels=8, embed_dim=16,
                      pooling_func="ASTP", two_emb_layer=True)),
        dict(family="tfgridnet", scope="spk_model", speaker="ResNet")),
    "campplus": ("DPCCN", dict(
        win=512, stride=128, tcn_blocks=1, tcn_layers=1, spk_emb_dim=16,
        joint_training=True, spk_feat=True, spk_model="CAMPPlus",
        spk_args=dict(feat_dim=24, embed_dim=16)),
        dict(family="dpccn", scope="spk_model", speaker="CAMPPlus")),
}


def _seeded_model(name, args, seed):
    """The port model with every floating tensor moved by numpy noise
    (the variances kept positive), so biases and statistics are not at
    their initial zeros and ones."""
    torch.manual_seed(seed)
    model = get_model(name)(**args)
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        z = torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
        state[k] = z.abs() + 0.5 if k.endswith(".var") else v + 0.05 * z
    model.load_state_dict(state)
    return model


def _write_reference(root, case, seed=0, bundle=False):
    """(the port model, the .pt path, the config path) of a case; with
    `bundle` the .pt is the reference's {"models": [...]} bundle of a DDP
    run ("module." names)."""
    name, args, layout = CASES[case]
    model = _seeded_model(name, args, seed)
    ref = reference_state_dict(state=model.state_dict(), **layout)
    tensors = {k: torch.from_numpy(v) for k, v in ref.items()}
    if bundle:
        tensors = {"models": [{f"module.{k}": v
                               for k, v in tensors.items()}]}
    pt = os.path.join(root, f"{case}.pt")
    torch.save(tensors, pt)
    config = {"model": {"tse_model": name},
              "model_args": {"tse_model": dict(args)},
              "dataset_args": {"resample_rate": 16000}}
    cfg = os.path.join(root, f"{case}.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    return model, pt, cfg


def _jax_convert(monkeypatch, pt, cfg, out):
    monkeypatch.setattr(sys, "argv", ["convert", "--torch_ckpt", pt,
                                      "--config", cfg, "--out", out])
    jax_convert.main()


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_state_dict_maps_back_exactly(tmp_path, monkeypatch,
                                                case):
    model, pt, cfg = _write_reference(str(tmp_path), case,
                                      bundle=case == "dpccn")
    ours = str(tmp_path / "port.ckpt")
    logs = []
    state, buffers = convert(pt, cfg, ours, log=logs.append)
    _assert_same_state(dict(state, **buffers), model.state_dict())
    _assert_same_state(model_state(load_checkpoint(ours)),
                       model.state_dict())
    if CASES[case][2].get("speaker"):
        assert any("speaker branch" in line for line in logs), logs
    # the JAX package's converter of the same .pt, across the bridge
    theirs = str(tmp_path / "jax.ckpt")
    _jax_convert(monkeypatch, pt, cfg, theirs)
    _assert_same_state(model_state(load_checkpoint(theirs)),
                       model.state_dict())


def test_each_map_matches_the_jax_map_through_the_bridge(tmp_path):
    """Each map alone, on the same numpy dict: the port's tree, carried
    over the bridge, equals the JAX package's tree carried over it."""
    _, pt, _ = _write_reference(str(tmp_path), "resnet", seed=3)
    sd = torch_port.load_torch_state_dict(pt)
    spk = {k[len("spk_model."):]: v for k, v in sd.items()
           if k.startswith("spk_model.")}
    for fn in ("port_wespeaker_resnet_state_dict",):
        got = port_state_from_jax(*getattr(torch_port, fn)(spk))
        want = port_state_from_jax(*getattr(jax_torch_port, fn)(spk))
        for part_got, part_want in zip(got, want):
            _assert_same_state(part_got, part_want)
    grid = {k: v for k, v in sd.items() if not k.startswith("spk_model.")}
    got = torch_port.port_tfgridnet_state_dict(grid)
    want = jax_torch_port.port_tfgridnet_state_dict(grid)
    _assert_same_state(port_state_from_jax(got)[0],
                       port_state_from_jax(want)[0])
    # the scan tree of the JAX package, unstacked again by the bridge
    stacked = torch_port.stack_gridnet_blocks(got)
    assert stacked["blocks"]["block"]["intra_rnn"]["wx_f"].shape[0] == 1
    jax_stacked = jax_torch_port.stack_gridnet_blocks(want)
    _assert_same_state(port_state_from_jax(stacked)[0],
                       port_state_from_jax(got)[0])
    _assert_same_state(port_state_from_jax(stacked)[0],
                       port_state_from_jax(jax_stacked)[0])
    with pytest.raises(KeyError, match="block_i"):
        torch_port.stack_gridnet_blocks({"conv": {}})


def test_converted_bundle_decodes_as_the_jax_one(tmp_path, monkeypatch):
    """The v1 BSRNN (FiLM fuse on every repeat, speaker transform) from a
    reference .pt: the port's bundle through the port's bin/infer against
    the JAX converter's bundle through the JAX bin/infer."""
    root = str(tmp_path)
    data = _write_shard(tmp_path, lengths=(6000, 7100), emb_dim=16)
    _, pt, cfg = _write_reference(root, "bsrnn", seed=5)
    ours, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    convert(pt, cfg, ours, log=lambda _: None)
    _jax_convert(monkeypatch, pt, cfg, theirs)
    with open(cfg) as f:
        config = yaml.safe_load(f)
    config["data_type"] = "shard"
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    want = jax_infer(cfg, checkpoint=theirs, exp_dir=str(tmp_path / "jax"),
                     length_bucket=2000, **data)
    got = infer(cfg, checkpoint=ours, exp_dir=str(tmp_path / "port"),
                length_bucket=2000, device="cpu", **data)
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3, \
        (got, want)
    names = sorted(n for n in os.listdir(tmp_path / "jax" / "audio")
                   if n.endswith(".wav"))
    assert len(names) == 4
    for name in names:
        a, _ = read_wav(str(tmp_path / "port" / "audio" / name))
        b, _ = read_wav(str(tmp_path / "jax" / "audio" / name))
        assert np.abs(a - b).max() <= 5e-4 * np.abs(b).max(), name
