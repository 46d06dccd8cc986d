"""State dicts in the reference PyTorch toolkit's layout, written by hand
from a port model's weights: the inverses of the maps in
wesep_tpu_torch/utils/torch_port.py (torch `nn.LSTM` names, gate order and
two biases; OIHW / [out, in, k] convolutions; [out, in] linears; one
module per band; the wespeaker encoders' names).

The reference tree is not in this repo, so a reference-layout dict is
built from the port's own weights: a map that brings it back exactly, and
the JAX package's map of the same dict, can then be checked against the
weights it started from. Each LSTM bias is split into two equal halves
(bias_ih + bias_hh), which add back exactly. Imports no JAX.
"""

import numpy as np

from wesep_tpu_torch.models.bsrnn import band_layout


def nested(state) -> dict:
    """A port state_dict (names joined by '.') -> nested dicts of numpy."""
    out = {}
    for name, value in state.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().cpu().numpy()
    return out


def _lstm(sd, prefix, r):
    for suffix, tag in (("", "f"), ("_reverse", "b")):
        sd[f"{prefix}.weight_ih_l0{suffix}"] = r[f"wx_{tag}"].T
        sd[f"{prefix}.weight_hh_l0{suffix}"] = r[f"wh_{tag}"].T
        half = r[f"b_{tag}"] * np.float32(0.5)
        sd[f"{prefix}.bias_ih_l0{suffix}"] = half
        sd[f"{prefix}.bias_hh_l0{suffix}"] = half.copy()


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["kernel"].T
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _conv1x1(sd, prefix, p):
    """Dense kernel [in, out] -> Conv1d [out, in, 1]."""
    sd[f"{prefix}.weight"] = p["kernel"].T[:, :, None]
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _conv1x1_2d(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["kernel"].T[:, :, None, None]
    sd[f"{prefix}.bias"] = p["bias"]


def _conv1d(sd, prefix, p):
    """[k, in, out] -> Conv1d [out, in, k]."""
    sd[f"{prefix}.weight"] = p["kernel"].transpose(2, 1, 0)
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _conv2d(sd, prefix, p):
    """HWIO (or a transposed conv's [kh, kw, out, in]) -> OIHW (or
    [in, out, kh, kw])."""
    sd[f"{prefix}.weight"] = p["kernel"].transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _bn(sd, prefix, p):
    if "scale" in p:
        sd[f"{prefix}.weight"] = p["scale"]
        sd[f"{prefix}.bias"] = p["bias"]
    sd[f"{prefix}.running_mean"] = p["mean"]
    sd[f"{prefix}.running_var"] = p["var"]


# ---- separators ---------------------------------------------------------------


def bsrnn(t, sr=16000, win=512, num_repeat=6, multi_fuse=False,
          spk_fuse_type="multiply", cross=False):
    """BSRNN / BSRNN_Multi (and BSRNN_Feats' core with `cross`)."""
    sd = {}
    groups = band_layout(sr, win // 2 + 1)
    band = 0
    for gi, (n, _) in enumerate(groups):
        for j in range(n):
            i = band + j
            sd[f"BN.{i}.0.weight"] = t[f"bn_norm_{gi}"]["scale"][j]
            sd[f"BN.{i}.0.bias"] = t[f"bn_norm_{gi}"]["bias"][j]
            _conv1x1(sd, f"BN.{i}.1", {k: v[j] for k, v in
                                       t[f"bn_proj_{gi}"].items()})
            sd[f"mask.{i}.0.weight"] = t[f"mask_norm_{gi}"]["scale"][j]
            sd[f"mask.{i}.0.bias"] = t[f"mask_norm_{gi}"]["bias"][j]
            for sub, name in ((1, "fc1"), (3, "fc2"), (5, "out")):
                _conv1x1(sd, f"mask.{i}.{sub}", {
                    k: v[j] for k, v in t[f"mask_{name}_{gi}"].items()})
        band += n
    for j, dense in sorted(t.get("spk_transform", {}).items()):
        # the reference's transforms interleave convs and activations
        _conv1x1(sd, f"spk_transform.transforms.{2 * int(j[6:])}", dense)
    if multi_fuse:
        fuse_idx = range(0, 2 * num_repeat, 2)
        bsnet_idx = range(1, 2 * num_repeat, 2)
    else:
        fuse_idx, bsnet_idx = [0], range(1, num_repeat + 1)
    fuse = "cross_fuse" if cross else "fuse"
    for j, idx in enumerate(fuse_idx):
        p = t.get(f"{fuse}_{j}")
        if p is None:
            continue
        base = f"separator.separation.{idx}.fc"
        if spk_fuse_type == "FiLM":
            for name, layer in p["FiLM_0"].items():
                kind, k = name.split("_")
                _linear(sd, f"{base}.{kind}_fcs.{k}", layer)
        else:
            _linear(sd, f"{base}.linear", p["Dense_0"])
    for j, idx in enumerate(bsnet_idx):
        for name in ("band_rnn", "band_comm"):
            r = t[f"bsnet_{j}"][name]
            base = f"separator.separation.{idx}.{name}"
            sd[f"{base}.norm.weight"] = r["norm_scale"]
            sd[f"{base}.norm.bias"] = r["norm_bias"]
            _lstm(sd, f"{base}.rnn", r["rnn"])
            _linear(sd, f"{base}.proj", r["proj"])
    if "pred_linear" in t:
        _linear(sd, "pred_linear", t["pred_linear"])
    if cross:
        _linear(sd, "separator.attenFuse.0", t["cross_proj"])
        att = t["cross_att"]
        base = "separator.attenFuse.1.multihead_attn"
        sd[f"{base}.in_proj_weight"] = np.concatenate(
            [att[f"{q}_proj"]["kernel"].T for q in "qkv"])
        sd[f"{base}.in_proj_bias"] = np.concatenate(
            [att[f"{q}_proj"]["bias"] for q in "qkv"])
        _linear(sd, f"{base}.out_proj", att["out_proj"])
    return sd


def dpccn(t):
    sd = {}

    def dense_block(prefix, p):
        for i in range(1, 6):
            _conv2d(sd, f"{prefix}.conv{i}.conv2d", p[f"conv{i}"]["conv"])

    _conv2d(sd, "conv2d", t["conv2d"])
    dense_block("encoder.0", t["enc0"])
    for i in range(4):
        _conv2d(sd, f"encoder.{i + 1}.0.conv2d", t[f"enc{i + 1}_conv"]["conv"])
        dense_block(f"encoder.{i + 1}.1", t[f"enc{i + 1}_dense"])
    for j in range(3):
        _conv2d(sd, f"encoder.{5 + j}.conv2d", t[f"enc{5 + j}"]["conv"])
    if "spk_fuse" in t:
        _linear(sd, "spk_fuse.fc.linear", t["spk_fuse"]["Dense_0"])
    for name, p in t.items():
        if name.startswith("tcn_"):
            li, bi = name[4:].split("_")
            base = f"tcn_layers.{li}.{bi}"
            _conv1d(sd, f"{base}.dconv1", p["dconv1"])
            _conv1x1(sd, f"{base}.dconv2", p["dconv2"])
    for j in range(3):
        _conv2d(sd, f"decoder.{j}.convtrans2d", t[f"dec{j}"]["conv"])
    for i in range(4):
        dense_block(f"decoder.{3 + i}.0", t[f"dec{3 + i}_dense"])
        _conv2d(sd, f"decoder.{3 + i}.1.convtrans2d",
                t[f"dec{3 + i}_conv"]["conv"])
    dense_block("decoder.7", t["dec7"])
    pi = 0
    while f"avg_pool_{pi}" in t:
        _conv1x1_2d(sd, f"avg_pool.{pi}.1", t[f"avg_pool_{pi}"])
        pi += 1
    _conv1x1_2d(sd, "avg_proj", t["avg_proj"])
    _conv2d(sd, "deconv2d", t["deconv2d"])
    return sd


def tfgridnet(t):
    sd = {}
    _conv2d(sd, "conv.0", t["conv"])
    sd["conv.1.weight"] = t["conv_norm_scale"]
    sd["conv.1.bias"] = t["conv_norm_bias"]
    if "spk_fuse" in t:
        _linear(sd, "spk_fuse.fc.linear", t["spk_fuse"]["Dense_0"])
    i = 0
    while f"block_{i}" in t:
        blk, base = t[f"block_{i}"], f"blocks.{i}"
        for name in ("intra", "inter"):
            sd[f"{base}.{name}_norm.weight"] = blk[f"{name}_norm"]["scale"]
            sd[f"{base}.{name}_norm.bias"] = blk[f"{name}_norm"]["bias"]
            _lstm(sd, f"{base}.{name}_rnn", blk[f"{name}_rnn"])
            lin = blk[f"{name}_linear"]
            if lin["kernel"].ndim == 3:  # ConvTranspose1d [in, out, k]
                sd[f"{base}.{name}_linear.weight"] = \
                    lin["kernel"].transpose(2, 1, 0)
                sd[f"{base}.{name}_linear.bias"] = lin["bias"]
            else:
                _linear(sd, f"{base}.{name}_linear", lin)
        for tag in "QKV":
            _conv1x1_2d(sd, f"{base}.attn_conv_{tag}", blk[f"attn_conv_{tag}"])
            sd[f"{base}.attn_norm_{tag}.act.weight"] = \
                blk[f"attn_norm_{tag}_prelu"]
            sd[f"{base}.attn_norm_{tag}.gamma"] = \
                blk[f"attn_norm_{tag}_scale"][None, :, :, None, :]
            sd[f"{base}.attn_norm_{tag}.beta"] = \
                blk[f"attn_norm_{tag}_bias"][None, :, :, None, :]
        _conv1x1_2d(sd, f"{base}.attn_concat_proj.0", blk["attn_proj"])
        sd[f"{base}.attn_concat_proj.1.weight"] = blk["attn_proj_prelu"]
        sd[f"{base}.attn_concat_proj.2.gamma"] = \
            blk["attn_proj_norm_scale"][None, :, None, :]
        sd[f"{base}.attn_concat_proj.2.beta"] = \
            blk["attn_proj_norm_bias"][None, :, None, :]
        i += 1
    _conv2d(sd, "deconv", t["deconv"])
    return sd


def convtasnet(t):
    sd = {}
    enc = t["encoder"]
    for name in ("short", "middle", "long"):
        _conv1d(sd, f"encoder.encoder_1d_{name}", enc[f"enc_{name}"]["Conv_0"])
    ln = enc["ChannelLayerNorm_0"]["LayerNorm_0"]
    sd["encoder.ln.weight"] = ln["scale"][None, :, None]
    sd["encoder.ln.bias"] = ln["bias"][None, :, None]
    _conv1d(sd, "encoder.proj", enc["proj"]["Conv_0"])

    def block(base, p, names):
        conv1x1, prelu1, norm1, dconv, prelu2, norm2, sconv = names
        _conv1d(sd, f"{base}.{conv1x1}", p["Conv1d_0"]["Conv_0"])
        sd[f"{base}.{prelu1}.weight"] = p["PReLU_0"]["alpha"]
        sd[f"{base}.{norm1}.weight"] = p["GlobalLayerNorm_0"]["weight"][
            :, None]
        sd[f"{base}.{norm1}.bias"] = p["GlobalLayerNorm_0"]["bias"][:, None]
        _conv1d(sd, f"{base}.{dconv}", p["Conv1d_1"])
        sd[f"{base}.{prelu2}.weight"] = p["PReLU_1"]["alpha"]
        sd[f"{base}.{norm2}.weight"] = p["GlobalLayerNorm_1"]["weight"][
            :, None]
        sd[f"{base}.{norm2}.bias"] = p["GlobalLayerNorm_1"]["bias"][:, None]
        _conv1d(sd, f"{base}.{sconv}", p["Conv1d_2"]["Conv_0"])

    r = 0
    while f"fuse_{r}" in t:
        block(f"separation.separation.{2 * r}", t[f"fuse_{r}"],
              ("conv1x1", "prelu1", "lnorm1", "dconv", "prelu2", "lnorm2",
               "sconv"))
        for name, p in t[f"tcn_{r}"].items():
            block(f"separation.separation.{2 * r + 1}.separation."
                  f"{name.split('_')[1]}", p,
                  ("conv1x1", "PReLU_1", "norm_1", "dwconv", "PReLU_2",
                   "norm_2", "Output"))
        r += 1
    for i in range(3):
        _conv1d(sd, f"decoder.mask{i + 1}", t[f"mask_{i}"]["Conv_0"])
        p = t[f"dec_{i}"]["ConvTranspose_0"]
        # [k, in, out], spatially reversed -> ConvTranspose1d [in, out, k]
        sd[f"decoder.decoder_1d_{i + 1}.weight"] = np.ascontiguousarray(
            p["kernel"][::-1].transpose(1, 2, 0))
        sd[f"decoder.decoder_1d_{i + 1}.bias"] = p["bias"]
    return sd


# ---- wespeaker encoders (keys relative to the encoder) -----------------------


def ecapa_wespeaker(t):
    sd = {}

    def crb(prefix, p):
        _conv1d(sd, f"{prefix}.conv", p["conv"]["Conv_0"])
        _bn(sd, f"{prefix}.bn", p["bn"])

    crb("layer1", t["layer1"])
    for k in (2, 3, 4):
        p, base = t[f"layer{k}"], f"layer{k}.se_res2block"
        crb(f"{base}.0", p["conv_in"])
        i = 0
        while f"convs_{i}" in p["res2"]:
            _conv1d(sd, f"{base}.1.convs.{i}",
                    p["res2"][f"convs_{i}"]["Conv_0"])
            _bn(sd, f"{base}.1.bns.{i}", p["res2"][f"bns_{i}"])
            i += 1
        crb(f"{base}.2", p["conv_out"])
        _linear(sd, f"{base}.3.linear1", p["se"]["linear1"])
        _linear(sd, f"{base}.3.linear2", p["se"]["linear2"])
    _conv1d(sd, "conv", t["conv"]["Conv_0"])
    _conv1x1(sd, "pool.linear1", t["pool"]["linear1"])
    _conv1x1(sd, "pool.linear2", t["pool"]["linear2"])
    _bn(sd, "bn", t["bn"])
    _linear(sd, "linear", t["linear"])
    if "bn2" in t:
        _bn(sd, "bn2", t["bn2"])
    return sd


def _unpermute(x, perm, axis=0):
    """The inverse of x.take(perm, axis)."""
    out = np.empty_like(x)
    index = [slice(None)] * x.ndim
    index[axis] = perm
    out[tuple(index)] = x
    return out


def resnet(t):
    sd = {}
    _conv2d(sd, "conv1", t["conv1"])
    _bn(sd, "bn1", t["bn1"])
    c_out = t["bn1"]["scale"].shape[0]
    for s in (1, 2, 3, 4):
        i = 0
        while f"layer{s}_{i}" in t:
            p, base = t[f"layer{s}_{i}"], f"layer{s}.{i}"
            j = 1
            while f"conv{j}" in p:
                _conv2d(sd, f"{base}.conv{j}", p[f"conv{j}"])
                _bn(sd, f"{base}.bn{j}", p[f"bn{j}"])
                c_out = p[f"bn{j}"]["scale"].shape[0]
                j += 1
            if "shortcut_conv" in p:
                _conv2d(sd, f"{base}.shortcut.0", p["shortcut_conv"])
                _bn(sd, f"{base}.shortcut.1", p["shortcut_bn"])
            i += 1
    seg1 = t["seg_1"]["kernel"]  # [2 CF, emb], f-major features
    cf = seg1.shape[0] // 2
    f_out = cf // c_out
    j = np.arange(f_out * c_out)
    perm = (j % c_out) * f_out + j // c_out
    if "pool" in t:
        w1 = t["pool"]["linear1"]["kernel"]
        blocks = w1.shape[0] // cf
        w1 = np.concatenate([_unpermute(w1[k * cf:(k + 1) * cf], perm)
                             for k in range(blocks)])
        sd["pool.linear1.weight"] = w1.T[:, :, None]
        sd["pool.linear1.bias"] = t["pool"]["linear1"]["bias"]
        lin2 = t["pool"]["linear2"]
        sd["pool.linear2.weight"] = _unpermute(lin2["kernel"], perm,
                                               axis=1).T[:, :, None]
        sd["pool.linear2.bias"] = _unpermute(lin2["bias"], perm)
    sd["seg_1.weight"] = np.concatenate(
        [_unpermute(seg1[:cf], perm), _unpermute(seg1[cf:], perm)]).T
    sd["seg_1.bias"] = t["seg_1"]["bias"]
    if "seg_2" in t:
        _bn(sd, "seg_bn_1", t["seg_bn_1"])
        _linear(sd, "seg_2", t["seg_2"])
    return sd


def campplus(t):
    sd = {}
    head = t["head"]
    _conv2d(sd, "head.conv1", head["conv1"])
    _bn(sd, "head.bn1", head["bn1"])
    for stage in (1, 2):
        for i in (0, 1):
            p, base = head[f"layer{stage}_{i}"], f"head.layer{stage}.{i}"
            for j in (1, 2):
                _conv2d(sd, f"{base}.conv{j}", p[f"conv{j}"])
                _bn(sd, f"{base}.bn{j}", p[f"bn{j}"])
            if "shortcut_conv" in p:
                _conv2d(sd, f"{base}.shortcut.0", p["shortcut_conv"])
                _bn(sd, f"{base}.shortcut.1", p["shortcut_bn"])
    _conv2d(sd, "head.conv2", head["conv2"])
    _bn(sd, "head.bn2", head["bn2"])
    _conv1d(sd, "xvector.tdnn.linear", t["tdnn"]["Conv_0"])
    _bn(sd, "xvector.tdnn.nonlinear.batchnorm", t["tdnn_bn"])
    for stage in (1, 2, 3):
        i = 0
        while f"block{stage}_layer{i}" in t:
            p = t[f"block{stage}_layer{i}"]
            base = f"xvector.block{stage}.tdnnd{i + 1}"
            _bn(sd, f"{base}.nonlinear1.batchnorm", p["bn1"])
            _conv1d(sd, f"{base}.linear1", p["conv1"]["Conv_0"])
            _bn(sd, f"{base}.nonlinear2.batchnorm", p["bn2"])
            for name in ("linear_local", "linear1", "linear2"):
                _conv1d(sd, f"{base}.cam_layer.{name}",
                        p["cam"][name]["Conv_0"])
            i += 1
        _bn(sd, f"xvector.transit{stage}.nonlinear.batchnorm",
            t[f"transit{stage}_bn"])
        _conv1d(sd, f"xvector.transit{stage}.linear",
                t[f"transit{stage}_conv"]["Conv_0"])
    _bn(sd, "xvector.out_nonlinear.batchnorm", t["out_bn"])
    _conv1x1(sd, "xvector.dense.linear", t["dense"])
    _bn(sd, "xvector.dense.nonlinear.batchnorm", t["dense_bn"])
    return sd


SPEAKERS = {"ECAPA": ecapa_wespeaker, "ResNet": resnet, "CAMPPlus": campplus}


def reference_state_dict(family: str, state, scope=None, speaker=None,
                         **kwargs) -> dict:
    """The reference-layout state dict of a port model's `state` (its
    state_dict, parameters and buffers): `family` one of bsrnn,
    bsrnn_feats, dpccn, tfgridnet, convtasnet; a joint model's encoder
    under `scope` (spk_model_net / spk_model) in the wespeaker layout
    `speaker` (ECAPA, ResNet, CAMPPlus), as `spk_model.*`."""
    t = nested(state)
    spk = t.pop(scope) if scope else None
    if family == "bsrnn_feats":
        sd = bsrnn(t, cross=kwargs["spk_fuse_type"].startswith("cross"),
                   **kwargs)
    else:
        sd = {"bsrnn": bsrnn, "dpccn": dpccn, "tfgridnet": tfgridnet,
              "convtasnet": convtasnet}[family](t, **kwargs)
    if spk is not None:
        sd.update({f"spk_model.{k}": v
                   for k, v in SPEAKERS[speaker](spk).items()})
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}
