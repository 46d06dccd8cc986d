"""The reference's PyTorch checkpoints -> the port's state_dicts.

The port's copy of wesep_tpu/utils/torch_port.py: each map takes a state
dict of the reference toolkit (wenet-e2e/wesep; torch `nn.LSTM` names and
gate order, OIHW convolutions, [out, in] linears; numpy values) and gives
the JAX package's param tree of the same model (nested dicts of numpy
arrays, flax names and layouts). `port_reference_state` then carries that
tree over the weight bridge (utils/jax_params.port_state_from_jax), so a
reference checkpoint becomes the port's own (parameters, buffers) by name.

Covered: the separator cores of BSRNN / BSRNN_Multi (band norms,
bottlenecks, fuse incl. FiLM, BSNets, mask MLPs, speaker transform),
BSRNN_Feats (its TF-map band widths and the cross-attention stack), DPCCN,
TF-GridNet and ConvTasNet / SpEx+, and the three wespeaker speaker
encoders that the reference's joint configs name: ECAPA-TDNN (the port's
`layout: wespeaker`), ResNet and CAM++. tools/convert_torch_checkpoint.py
picks the map by the config's model and the encoder by its keys.
`stack_gridnet_blocks` gives the JAX package's `scan_layers` tree of an
unrolled TF-GridNet, which the bridge unstacks again.
"""

from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "port_bsrnn_state_dict",
    "port_bsrnn_feats_state_dict",
    "port_dpccn_state_dict",
    "port_tfgridnet_state_dict",
    "port_convtasnet_state_dict",
    "port_wespeaker_ecapa_state_dict",
    "port_wespeaker_resnet_state_dict",
    "port_wespeaker_campplus_state_dict",
    "load_torch_state_dict",
    "stack_gridnet_blocks",
    "port_reference_state",
]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch .pt checkpoint into {key: numpy} (handles the
    reference's {'models': [state_dict, ...]} bundles and raw
    state_dicts)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "models" in obj:
        obj = obj["models"][0]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    out = {}
    for k, v in obj.items():
        k = k.removeprefix("module.")  # DDP wrapper
        out[k] = np.asarray(v.detach().cpu().numpy())
    return out


def _lstm(sd, prefix):
    out = {}
    for suffix, tag in (("", "f"), ("_reverse", "b")):
        out[f"wx_{tag}"] = sd[f"{prefix}.weight_ih_l0{suffix}"].T
        out[f"wh_{tag}"] = sd[f"{prefix}.weight_hh_l0{suffix}"].T
        out[f"b_{tag}"] = (
            sd[f"{prefix}.bias_ih_l0{suffix}"]
            + sd[f"{prefix}.bias_hh_l0{suffix}"]
        )
    return out


def _resrnn(sd, prefix):
    return {
        "norm_scale": sd[f"{prefix}.norm.weight"],
        "norm_bias": sd[f"{prefix}.norm.bias"],
        "rnn": _lstm(sd, f"{prefix}.rnn"),
        "proj": {
            "kernel": sd[f"{prefix}.proj.weight"].T,
            "bias": sd[f"{prefix}.proj.bias"],
        },
    }


def _conv1x1(sd, prefix):
    return {
        "kernel": sd[f"{prefix}.weight"][:, :, 0].T,
        "bias": sd[f"{prefix}.bias"],
    }


def _grouped(stacks):
    return {k: np.stack([s[k] for s in stacks]) for k in stacks[0]}


def port_bsrnn_state_dict(
    sd: Dict[str, np.ndarray],
    sr: int = 16000,
    win: int = 512,
    num_repeat: int = 6,
    multi_fuse: bool = False,
    use_spk_transform: bool = False,
    spk_fuse_type: str = "multiply",
    spk_map: Optional[Callable[[Dict[str, np.ndarray]], dict]] = None,
) -> dict:
    """Reference BSRNN state_dict -> the JAX package's BSRNN params.

    spk_map: optional fn mapping the `spk_model.*` sub-dict onto the
    `spk_model_net` flax subtree (wespeaker-layout dependent).
    """
    from wesep_tpu_torch.models.bsrnn import band_layout

    groups = band_layout(sr, win // 2 + 1)
    params: dict = {}

    band = 0
    for gi, (n, bw) in enumerate(groups):
        norms, projs = [], []
        for i in range(band, band + n):
            norms.append({
                "scale": sd[f"BN.{i}.0.weight"],
                "bias": sd[f"BN.{i}.0.bias"],
            })
            projs.append(_conv1x1(sd, f"BN.{i}.1"))
        params[f"bn_norm_{gi}"] = _grouped(norms)
        params[f"bn_proj_{gi}"] = _grouped(projs)
        band += n

    if use_spk_transform:
        convs = sorted(
            {
                int(k.split(".")[2])
                for k in sd
                if k.startswith("spk_transform.transforms.")
            }
        )
        params["spk_transform"] = {
            f"Dense_{j}": _conv1x1(sd, f"spk_transform.transforms.{idx}")
            for j, idx in enumerate(convs)
        }

    # separator: multi_fuse -> [fuse, bsnet] * R; else fuse + bsnet * R
    if multi_fuse:
        fuse_idx = list(range(0, 2 * num_repeat, 2))
        bsnet_idx = list(range(1, 2 * num_repeat, 2))
    else:
        fuse_idx = [0]
        bsnet_idx = list(range(1, num_repeat + 1))
    if spk_fuse_type != "None":
        for j, idx in enumerate(fuse_idx):
            base = f"separator.separation.{idx}.fc"
            if spk_fuse_type == "FiLM":
                # reference FiLM (norm.py:84-139): gamma_fcs/beta_fcs
                # Linear stacks -> flax FiLM gamma_{i}/beta_{i} Dense
                film = {}
                layer = 0
                while f"{base}.gamma_fcs.{layer}.weight" in sd:
                    film[f"gamma_{layer}"] = {
                        "kernel": sd[f"{base}.gamma_fcs.{layer}.weight"].T,
                        "bias": sd[f"{base}.gamma_fcs.{layer}.bias"],
                    }
                    film[f"beta_{layer}"] = {
                        "kernel": sd[f"{base}.beta_fcs.{layer}.weight"].T,
                        "bias": sd[f"{base}.beta_fcs.{layer}.bias"],
                    }
                    layer += 1
                if layer == 0:
                    raise KeyError(f"no FiLM weights under {base}")
                params[f"fuse_{j}"] = {"FiLM_0": film}
            else:
                params[f"fuse_{j}"] = {
                    "Dense_0": {
                        "kernel": sd[f"{base}.linear.weight"].T,
                        "bias": sd[f"{base}.linear.bias"],
                    }
                }
    for j, idx in enumerate(bsnet_idx):
        base = f"separator.separation.{idx}"
        params[f"bsnet_{j}"] = {
            "band_rnn": _resrnn(sd, f"{base}.band_rnn"),
            "band_comm": _resrnn(sd, f"{base}.band_comm"),
        }

    band = 0
    for gi, (n, bw) in enumerate(groups):
        norms, fc1, fc2, out = [], [], [], []
        for i in range(band, band + n):
            norms.append({
                "scale": sd[f"mask.{i}.0.weight"],
                "bias": sd[f"mask.{i}.0.bias"],
            })
            fc1.append(_conv1x1(sd, f"mask.{i}.1"))
            fc2.append(_conv1x1(sd, f"mask.{i}.3"))
            out.append(_conv1x1(sd, f"mask.{i}.5"))
        params[f"mask_norm_{gi}"] = _grouped(norms)
        params[f"mask_fc1_{gi}"] = _grouped(fc1)
        params[f"mask_fc2_{gi}"] = _grouped(fc2)
        params[f"mask_out_{gi}"] = _grouped(out)
        band += n

    if spk_map is not None:
        spk_sd = {
            k.removeprefix("spk_model."): v
            for k, v in sd.items()
            if k.startswith("spk_model.")
        }
        if spk_sd:
            params["spk_model_net"] = spk_map(spk_sd)
    if "pred_linear.weight" in sd:
        params["pred_linear"] = {
            "kernel": sd["pred_linear.weight"].T,
            "bias": sd["pred_linear.bias"],
        }
    return params


def port_bsrnn_feats_state_dict(
    sd: Dict[str, np.ndarray],
    sr: int = 16000,
    win: int = 512,
    num_repeat: int = 6,
    multi_fuse: bool = False,
    use_spk_transform: bool = False,
    spk_fuse_type: str = "concat",
    spk_map: Optional[Callable[[Dict[str, np.ndarray]], dict]] = None,
) -> dict:
    """Reference BSRNN_Feats state_dict -> the JAX package's BSRNN_Feats params.

    The BN/separator/mask core is the BSRNN mapping (tfmap_* configs only
    change the BN input widths, carried by the weights themselves). For
    cross_* fusion it additionally ports the attenFuse stack
    (wesep/models/bsrnn_feats.py:131-137): the frame-
    feature Linear -> `cross_proj`, the nn.MultiheadAttention ->
    `cross_att` q/k/v/out Dense split, and renames the interleaved fuse
    layers to the `cross_fuse_{i}` scopes of the flax cross path.
    """
    params = port_bsrnn_state_dict(
        sd,
        sr=sr,
        win=win,
        num_repeat=num_repeat,
        multi_fuse=multi_fuse,
        use_spk_transform=use_spk_transform,
        spk_fuse_type=spk_fuse_type or "None",
        spk_map=spk_map,
    )
    if spk_fuse_type and spk_fuse_type.startswith("cross_"):
        for i in range(num_repeat if multi_fuse else 1):
            if f"fuse_{i}" in params:
                params[f"cross_fuse_{i}"] = params.pop(f"fuse_{i}")
        params["cross_proj"] = {
            "kernel": sd["separator.attenFuse.0.weight"].T,
            "bias": sd["separator.attenFuse.0.bias"],
        }
        w = sd["separator.attenFuse.1.multihead_attn.in_proj_weight"]
        b = sd["separator.attenFuse.1.multihead_attn.in_proj_bias"]
        n = w.shape[1]
        params["cross_att"] = {
            "q_proj": {"kernel": w[:n].T, "bias": b[:n]},
            "k_proj": {"kernel": w[n:2 * n].T, "bias": b[n:2 * n]},
            "v_proj": {"kernel": w[2 * n:].T, "bias": b[2 * n:]},
            "out_proj": {
                "kernel": sd[
                    "separator.attenFuse.1.multihead_attn.out_proj.weight"
                ].T,
                "bias": sd[
                    "separator.attenFuse.1.multihead_attn.out_proj.bias"
                ],
            },
        }
    return params


# ---- DPCCN (reference wesep/models/dpccn.py) --------------------------------

def _conv2d_sd(sd, prefix):
    """torch Conv2d [out,in,kh,kw] -> flax NHWC kernel [kh,kw,in,out]."""
    return {
        "kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0),
        "bias": sd[f"{prefix}.bias"],
    }


def _convtrans2d_sd(sd, prefix):
    """torch ConvTranspose2d [in,out,kh,kw] -> flax transpose_kernel=True
    kernel [kh,kw,out,in]."""
    return {
        "kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0),
        "bias": sd[f"{prefix}.bias"],
    }


def _conv1x1_2d_sd(sd, prefix):
    return {
        "kernel": sd[f"{prefix}.weight"][:, :, 0, 0].T,
        "bias": sd[f"{prefix}.bias"],
    }


def _dense_block_sd(sd, prefix):
    return {
        f"conv{i}": {"conv": _conv2d_sd(sd, f"{prefix}.conv{i}.conv2d")}
        for i in range(1, 6)
    }


def port_dpccn_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """Reference DPCCN state_dict -> the JAX package's DPCCN params
    (layout per tests/test_dpccn.py; reference dpccn.py:131-204)."""
    p: dict = {}
    p["conv2d"] = _conv2d_sd(sd, "conv2d")
    p["enc0"] = _dense_block_sd(sd, "encoder.0")
    for i in range(4):
        p[f"enc{i + 1}_conv"] = {
            "conv": _conv2d_sd(sd, f"encoder.{i + 1}.0.conv2d")
        }
        p[f"enc{i + 1}_dense"] = _dense_block_sd(sd, f"encoder.{i + 1}.1")
    for j in range(3):
        p[f"enc{5 + j}"] = {
            "conv": _conv2d_sd(sd, f"encoder.{5 + j}.conv2d")
        }

    if "spk_fuse.fc.linear.weight" in sd:
        p["spk_fuse"] = {
            "Dense_0": {
                "kernel": sd["spk_fuse.fc.linear.weight"].T,
                "bias": sd["spk_fuse.fc.linear.bias"],
            }
        }

    li = 0
    while f"tcn_layers.{li}.0.dconv1.weight" in sd:
        bi = 0
        while f"tcn_layers.{li}.{bi}.dconv1.weight" in sd:
            base = f"tcn_layers.{li}.{bi}"
            p[f"tcn_{li}_{bi}"] = {
                "dconv1": {
                    "kernel": sd[f"{base}.dconv1.weight"].transpose(2, 1, 0),
                    "bias": sd[f"{base}.dconv1.bias"],
                },
                "dconv2": {
                    "kernel": sd[f"{base}.dconv2.weight"][:, :, 0].T,
                    "bias": sd[f"{base}.dconv2.bias"],
                },
            }
            bi += 1
        li += 1

    for j in range(3):
        p[f"dec{j}"] = {
            "conv": _convtrans2d_sd(sd, f"decoder.{j}.convtrans2d")
        }
    for i in range(4):
        p[f"dec{3 + i}_dense"] = _dense_block_sd(sd, f"decoder.{3 + i}.0")
        p[f"dec{3 + i}_conv"] = {
            "conv": _convtrans2d_sd(sd, f"decoder.{3 + i}.1.convtrans2d")
        }
    p["dec7"] = _dense_block_sd(sd, "decoder.7")

    pi = 0
    while f"avg_pool.{pi}.1.weight" in sd:
        p[f"avg_pool_{pi}"] = _conv1x1_2d_sd(sd, f"avg_pool.{pi}.1")
        pi += 1
    p["avg_proj"] = _conv1x1_2d_sd(sd, "avg_proj")
    p["deconv2d"] = _convtrans2d_sd(sd, "deconv2d")
    return p


# ---- TF-GridNet (reference wesep/models/tfgridnet.py + gridnet_block.py) ----

def port_tfgridnet_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """Reference TFGridNet state_dict -> the JAX package's TFGridNet params
    (layout per tests/test_tfgridnet.py; reference gridnet_block.py)."""
    p: dict = {}
    p["conv"] = _conv2d_sd(sd, "conv.0")
    p["conv_norm_scale"] = sd["conv.1.weight"]
    p["conv_norm_bias"] = sd["conv.1.bias"]
    if "spk_fuse.fc.linear.weight" in sd:
        p["spk_fuse"] = {
            "Dense_0": {
                "kernel": sd["spk_fuse.fc.linear.weight"].T,
                "bias": sd["spk_fuse.fc.linear.bias"],
            }
        }
    i = 0
    while f"blocks.{i}.intra_norm.weight" in sd:
        base = f"blocks.{i}"
        blk: dict = {}
        for name in ("intra", "inter"):
            blk[f"{name}_norm"] = {
                "scale": sd[f"{base}.{name}_norm.weight"],
                "bias": sd[f"{base}.{name}_norm.bias"],
            }
            blk[f"{name}_rnn"] = _lstm(sd, f"{base}.{name}_rnn")
            lin_w = sd[f"{base}.{name}_linear.weight"]
            if lin_w.ndim == 3:
                # ConvTranspose1d [in, out, k] -> flax transpose_kernel
                # kernel [k, out, in]
                blk[f"{name}_linear"] = {
                    "kernel": lin_w.transpose(2, 1, 0),
                    "bias": sd[f"{base}.{name}_linear.bias"],
                }
            else:
                blk[f"{name}_linear"] = {
                    "kernel": lin_w.T,
                    "bias": sd[f"{base}.{name}_linear.bias"],
                }
        for tag in ("Q", "K", "V"):
            blk[f"attn_conv_{tag}"] = _conv1x1_2d_sd(
                sd, f"{base}.attn_conv_{tag}"
            )
            blk[f"attn_norm_{tag}_prelu"] = sd[
                f"{base}.attn_norm_{tag}.act.weight"
            ]
            blk[f"attn_norm_{tag}_scale"] = sd[
                f"{base}.attn_norm_{tag}.gamma"
            ][0, :, :, 0, :]
            blk[f"attn_norm_{tag}_bias"] = sd[
                f"{base}.attn_norm_{tag}.beta"
            ][0, :, :, 0, :]
        blk["attn_proj"] = _conv1x1_2d_sd(sd, f"{base}.attn_concat_proj.0")
        blk["attn_proj_prelu"] = sd[f"{base}.attn_concat_proj.1.weight"]
        blk["attn_proj_norm_scale"] = sd[
            f"{base}.attn_concat_proj.2.gamma"
        ][0, :, 0, :]
        blk["attn_proj_norm_bias"] = sd[
            f"{base}.attn_concat_proj.2.beta"
        ][0, :, 0, :]
        p[f"block_{i}"] = blk
        i += 1
    p["deconv"] = _convtrans2d_sd(sd, "deconv")
    return p


# ---- ConvTasNet / SpEx+ (reference wesep/models/convtasnet.py) --------------

def _conv1d_sd(sd, prefix):
    """torch Conv1d [out, in, k] -> flax Conv kernel [k, in, out]."""
    return {
        "kernel": sd[f"{prefix}.weight"].transpose(2, 1, 0),
        "bias": sd[f"{prefix}.bias"],
    }


def _convtrans1d_sd(sd, prefix):
    """torch ConvTranspose1d [in, out, k] -> flax ConvTranspose
    (transpose_kernel=False) kernel [k, in, out], spatially flipped."""
    return {
        "kernel": np.ascontiguousarray(
            sd[f"{prefix}.weight"].transpose(2, 0, 1)[::-1]
        ),
        "bias": sd[f"{prefix}.bias"],
    }


def _gln_sd(sd, prefix):
    return {
        "weight": sd[f"{prefix}.weight"].reshape(-1),
        "bias": sd[f"{prefix}.bias"].reshape(-1),
    }


def _prelu_sd(sd, prefix):
    return {"alpha": sd[f"{prefix}.weight"].reshape(-1)}


def _fuse_tcn_block_sd(sd, base):
    """Conv1DBlock4Fuse -> FuseTCNBlock params."""
    return {
        "Conv1d_0": {"Conv_0": _conv1d_sd(sd, f"{base}.conv1x1")},
        "PReLU_0": _prelu_sd(sd, f"{base}.prelu1"),
        "GlobalLayerNorm_0": _gln_sd(sd, f"{base}.lnorm1"),
        "Conv1d_1": _conv1d_sd(sd, f"{base}.dconv"),
        "PReLU_1": _prelu_sd(sd, f"{base}.prelu2"),
        "GlobalLayerNorm_1": _gln_sd(sd, f"{base}.lnorm2"),
        "Conv1d_2": {"Conv_0": _conv1d_sd(sd, f"{base}.sconv")},
    }


def _tcn_block_sd(sd, base):
    """Conv1DBlock -> TCNBlock params."""
    return {
        "Conv1d_0": {"Conv_0": _conv1d_sd(sd, f"{base}.conv1x1")},
        "PReLU_0": _prelu_sd(sd, f"{base}.PReLU_1"),
        "GlobalLayerNorm_0": _gln_sd(sd, f"{base}.norm_1"),
        "Conv1d_1": _conv1d_sd(sd, f"{base}.dwconv"),
        "PReLU_1": _prelu_sd(sd, f"{base}.PReLU_2"),
        "GlobalLayerNorm_1": _gln_sd(sd, f"{base}.norm_2"),
        "Conv1d_2": {"Conv_0": _conv1d_sd(sd, f"{base}.Output")},
    }


def port_convtasnet_state_dict(
    sd: Dict[str, np.ndarray], num_repeat: int = 4
) -> dict:
    """Reference ConvTasNet/SpEx+ (encoder_type=Multi) state_dict ->
    the JAX package's ConvTasNet params (layout per
    tests/test_convtasnet_parity.py; reference modules/tasnet/)."""
    p: dict = {}
    p["encoder"] = {
        "enc_short": {
            "Conv_0": _conv1d_sd(sd, "encoder.encoder_1d_short")
        },
        "enc_middle": {
            "Conv_0": _conv1d_sd(sd, "encoder.encoder_1d_middle")
        },
        "enc_long": {"Conv_0": _conv1d_sd(sd, "encoder.encoder_1d_long")},
        "ChannelLayerNorm_0": {"LayerNorm_0": {
            "scale": sd["encoder.ln.weight"].reshape(-1),
            "bias": sd["encoder.ln.bias"].reshape(-1),
        }},
        "proj": {"Conv_0": _conv1d_sd(sd, "encoder.proj")},
    }
    for r in range(num_repeat):
        fuse_base = f"separation.separation.{2 * r}"
        if f"{fuse_base}.conv1x1.weight" not in sd:
            break
        p[f"fuse_{r}"] = _fuse_tcn_block_sd(sd, fuse_base)
        inner = f"separation.separation.{2 * r + 1}.separation"
        blocks = {}
        i = 0
        while f"{inner}.{i}.conv1x1.weight" in sd:
            blocks[f"TCNBlock_{i}"] = _tcn_block_sd(sd, f"{inner}.{i}")
            i += 1
        p[f"tcn_{r}"] = blocks
    for i in range(3):
        p[f"mask_{i}"] = {
            "Conv_0": _conv1d_sd(sd, f"decoder.mask{i + 1}")
        }
        p[f"dec_{i}"] = {
            "ConvTranspose_0": _convtrans1d_sd(
                sd, f"decoder.decoder_1d_{i + 1}"
            )
        }
    return p


# ---- wespeaker ECAPA joint speaker branch (wespeaker/models/ecapa_tdnn.py,
# consumed by the reference's joint configs via
# wesep/models/bsrnn.py:9,217) -------------------------------

def _bn1d_sd(sd, prefix):
    """torch BatchNorm1d -> (flax params, flax batch_stats)."""
    return (
        {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
        {
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"],
        },
    )


def _linear_sd(sd, prefix):
    """torch Linear [out, in] -> flax Dense kernel [in, out]."""
    return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}


def _conv1x1_as_dense_sd(sd, prefix):
    """torch Conv1d k=1 [out, in, 1] -> flax Dense kernel [in, out]
    (channels-last layouts apply 1x1 convs as Dense)."""
    return {
        "kernel": sd[f"{prefix}.weight"][:, :, 0].T,
        "bias": sd[f"{prefix}.bias"],
    }


def _crb_sd(sd, prefix):
    """wespeaker Conv1dReluBn -> ecapa_ws._ConvReluBn (params, stats)."""
    bn_p, bn_s = _bn1d_sd(sd, f"{prefix}.bn")
    return (
        {"conv": {"Conv_0": _conv1d_sd(sd, f"{prefix}.conv")}, "bn": bn_p},
        {"bn": bn_s},
    )


def port_wespeaker_ecapa_state_dict(
    spk_sd: Dict[str, np.ndarray],
) -> Tuple[dict, dict]:
    """wespeaker ECAPA_TDNN state_dict (keys relative to the encoder, i.e.
    with any 'spk_model.' prefix already stripped) -> (params, batch_stats)
    for models.speaker.ecapa_ws.ECAPA_TDNN_WS.

    Layout mapped 1:1 (see ecapa_ws.py's header for the micro-structure):
    layer1 Conv1dReluBn; layer2-4 SE_Res2Block as nn.Sequential
    [.0 conv_in, .1 res2 (convs.{i}/bns.{i}), .2 conv_out, .3 SE]; 'conv'
    1x1 aggregator; 'pool' ASTP (1x1-conv attention -> Dense); 'bn';
    'linear'; optional 'bn2' (emb_bn=True checkpoints).
    """
    params: dict = {}
    stats: dict = {}
    params["layer1"], stats["layer1"] = _crb_sd(spk_sd, "layer1")
    for k in (2, 3, 4):
        base = f"layer{k}.se_res2block"
        blk_p: dict = {}
        blk_s: dict = {}
        blk_p["conv_in"], blk_s["conv_in"] = _crb_sd(spk_sd, f"{base}.0")
        res2_p: dict = {}
        res2_s: dict = {}
        i = 0
        while f"{base}.1.convs.{i}.weight" in spk_sd:
            res2_p[f"convs_{i}"] = {
                "Conv_0": _conv1d_sd(spk_sd, f"{base}.1.convs.{i}")
            }
            bn_p, bn_s = _bn1d_sd(spk_sd, f"{base}.1.bns.{i}")
            res2_p[f"bns_{i}"] = bn_p
            res2_s[f"bns_{i}"] = bn_s
            i += 1
        if i == 0:
            raise KeyError(f"no Res2 convs under {base}.1")
        blk_p["res2"] = res2_p
        blk_s["res2"] = res2_s
        blk_p["conv_out"], blk_s["conv_out"] = _crb_sd(spk_sd, f"{base}.2")
        blk_p["se"] = {
            "linear1": _linear_sd(spk_sd, f"{base}.3.linear1"),
            "linear2": _linear_sd(spk_sd, f"{base}.3.linear2"),
        }
        params[f"layer{k}"] = blk_p
        stats[f"layer{k}"] = blk_s
    params["conv"] = {"Conv_0": _conv1d_sd(spk_sd, "conv")}
    params["pool"] = {
        "linear1": _conv1x1_as_dense_sd(spk_sd, "pool.linear1"),
        "linear2": _conv1x1_as_dense_sd(spk_sd, "pool.linear2"),
    }
    params["bn"], stats["bn"] = _bn1d_sd(spk_sd, "bn")
    params["linear"] = _linear_sd(spk_sd, "linear")
    if "bn2.weight" in spk_sd:  # emb_bn=True
        params["bn2"], stats["bn2"] = _bn1d_sd(spk_sd, "bn2")
    return params, stats


# ---- wespeaker ResNet joint speaker branch (wespeaker/models/resnet.py,
# the reference's default joint encoder — spk_model 'ResNet34' in
# examples/librimix/tse/v2/confs/bsrnn.yaml:57-62) ------------

def _bn2d_sd(sd, prefix):
    return (
        {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
        {
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"],
        },
    )


def _conv2d_nobias_sd(sd, prefix):
    """torch Conv2d (bias=False) [out,in,kh,kw] -> flax [kh,kw,in,out]."""
    return {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}


def _cf_perm(c: int, f: int) -> np.ndarray:
    """Index map from this repo's (f-major) flattened frame features to
    wespeaker's (c-major): ours j = f*C + c reads torch index c*F + f.

    wespeaker's ResNet pools the conv map as (B, C*F, T) (C-major
    flatten); the flax ResNet emits [B, T, F*C] (channels-last). Any
    weight whose C*F-sized dim touches those features must be permuted.
    """
    j = np.arange(f * c)
    return (j % c) * f + j // c


def port_wespeaker_resnet_state_dict(
    spk_sd: Dict[str, np.ndarray],
) -> Tuple[dict, dict]:
    """wespeaker ResNet state_dict (keys relative to the encoder) ->
    (params, batch_stats) for models.speaker.resnet.ResNet.

    Handles Basic and Bottleneck blocks (conv3 fingerprint), numbered
    shortcut Sequentials, TSTP (param-free) and ASTP pooling (with the
    C-major -> F-major feature permutation of linear1/linear2/seg_1 —
    see _cf_perm), and the optional two-emb head (seg_bn_1 affine-free BN
    + seg_2).
    """
    params: dict = {}
    stats: dict = {}
    params["conv1"] = _conv2d_nobias_sd(spk_sd, "conv1")
    params["bn1"], stats["bn1"] = _bn2d_sd(spk_sd, "bn1")
    expansion = 1
    c_out = spk_sd["bn1.weight"].shape[0]
    for s in (1, 2, 3, 4):
        i = 0
        while f"layer{s}.{i}.conv1.weight" in spk_sd:
            base = f"layer{s}.{i}"
            blk_p: dict = {}
            blk_s: dict = {}
            convs = ("conv1", "conv2", "conv3") if (
                f"{base}.conv3.weight" in spk_sd) else ("conv1", "conv2")
            expansion = 4 if len(convs) == 3 else 1
            for j, cname in enumerate(convs, start=1):
                blk_p[cname] = _conv2d_nobias_sd(spk_sd, f"{base}.{cname}")
                blk_p[f"bn{j}"], blk_s[f"bn{j}"] = _bn2d_sd(
                    spk_sd, f"{base}.bn{j}"
                )
            if f"{base}.shortcut.0.weight" in spk_sd:
                blk_p["shortcut_conv"] = _conv2d_nobias_sd(
                    spk_sd, f"{base}.shortcut.0"
                )
                blk_p["shortcut_bn"], blk_s["shortcut_bn"] = _bn2d_sd(
                    spk_sd, f"{base}.shortcut.1"
                )
            c_out = spk_sd[f"{base}.bn{len(convs)}.weight"].shape[0]
            params[f"layer{s}_{i}"] = blk_p
            stats[f"layer{s}_{i}"] = blk_s
            i += 1
        if i == 0:
            raise KeyError(f"no blocks under layer{s}")

    seg1_w = spk_sd["seg_1.weight"]  # [emb, 2*C*F]
    cf = seg1_w.shape[1] // 2
    f_out = cf // c_out
    perm = _cf_perm(c_out, f_out)

    if "pool.linear1.weight" in spk_sd:  # ASTP
        w1 = spk_sd["pool.linear1.weight"][:, :, 0].T  # [in, bott]
        n_blocks = w1.shape[0] // cf  # 1 or 3 (global context)
        w1 = np.concatenate(
            [w1[k * cf : (k + 1) * cf][perm] for k in range(n_blocks)],
            axis=0,
        )
        w2 = spk_sd["pool.linear2.weight"][:, :, 0].T  # [bott, C*F]
        params["pool"] = {
            "linear1": {"kernel": w1, "bias": spk_sd["pool.linear1.bias"]},
            "linear2": {
                "kernel": w2[:, perm],
                "bias": spk_sd["pool.linear2.bias"][perm],
            },
        }

    seg1_k = seg1_w.T  # [2*C*F, emb]
    params["seg_1"] = {
        "kernel": np.concatenate([seg1_k[:cf][perm], seg1_k[cf:][perm]]),
        "bias": spk_sd["seg_1.bias"],
    }
    if "seg_2.weight" in spk_sd:  # two_emb_layer
        stats["seg_bn_1"] = {
            "mean": spk_sd["seg_bn_1.running_mean"],
            "var": spk_sd["seg_bn_1.running_var"],
        }
        params["seg_2"] = _linear_sd(spk_sd, "seg_2")
    return params, stats


def _stack(trees):
    """Nested dicts of equal structure -> one with their leaves stacked."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def stack_gridnet_blocks(params: dict) -> dict:
    """Unrolled TFGridNet params (block_0..block_{L-1} subtrees) -> the JAX
    package's scan_layers=True layout ('blocks/block' with stacked [L, ...]
    leaves), as its checkpoints of the scanned model hold them."""
    n = 0
    while f"block_{n}" in params:
        n += 1
    if n == 0:
        raise KeyError("no block_i subtrees to stack")
    out = {k: v for k, v in params.items() if not k.startswith("block_")}
    out["blocks"] = {"block": _stack([params[f"block_{i}"]
                                      for i in range(n)])}
    return out


# ---- wespeaker CAMPPlus joint speaker branch (wespeaker/models/campplus.py,
# spk_model 'CAMPPlus' in the reference's joint configs,
# examples/voxceleb1/v2/confs/bsrnn_online.yaml:69-75) -------------------


def _convk_sd(sd, prefix, bias=False):
    """torch Conv1d [out, in, k] -> common.Conv1d (non-depthwise: params
    live in the inner nn.Conv scope 'Conv_0') kernel [k, in, out]."""
    out = {"kernel": sd[f"{prefix}.weight"].transpose(2, 1, 0)}
    if bias:
        out["bias"] = sd[f"{prefix}.bias"]
    return {"Conv_0": out}


def port_wespeaker_campplus_state_dict(
    spk_sd: Dict[str, np.ndarray],
) -> Tuple[dict, dict]:
    """wespeaker CAMPPlus state_dict (keys relative to the encoder) ->
    (params, batch_stats) for models.speaker.campplus.CAMPPlus.

    The flax model flattens the FCM output C-major natively (see
    campplus.FCM), so unlike the ResNet port no _cf_perm permutation is
    needed; the map is purely structural: FCM res blocks (numbered
    shortcut Sequentials), the xvector Sequential's tdnn / blockN.tdnndM
    (1-indexed) / transitN / out_nonlinear stages, and the dense head
    (1x1 no bias + affine-free BN)."""
    params: dict = {}
    stats: dict = {}

    head_p: dict = {}
    head_s: dict = {}
    head_p["conv1"] = _conv2d_nobias_sd(spk_sd, "head.conv1")
    head_p["bn1"], head_s["bn1"] = _bn2d_sd(spk_sd, "head.bn1")
    for stage in (1, 2):
        for i in (0, 1):
            base = f"head.layer{stage}.{i}"
            blk_p: dict = {}
            blk_s: dict = {}
            for j in (1, 2):
                blk_p[f"conv{j}"] = _conv2d_nobias_sd(spk_sd, f"{base}.conv{j}")
                blk_p[f"bn{j}"], blk_s[f"bn{j}"] = _bn2d_sd(
                    spk_sd, f"{base}.bn{j}"
                )
            if f"{base}.shortcut.0.weight" in spk_sd:
                blk_p["shortcut_conv"] = _conv2d_nobias_sd(
                    spk_sd, f"{base}.shortcut.0"
                )
                blk_p["shortcut_bn"], blk_s["shortcut_bn"] = _bn2d_sd(
                    spk_sd, f"{base}.shortcut.1"
                )
            head_p[f"layer{stage}_{i}"] = blk_p
            head_s[f"layer{stage}_{i}"] = blk_s
    head_p["conv2"] = _conv2d_nobias_sd(spk_sd, "head.conv2")
    head_p["bn2"], head_s["bn2"] = _bn2d_sd(spk_sd, "head.bn2")
    params["head"] = head_p
    stats["head"] = head_s

    params["tdnn"] = _convk_sd(spk_sd, "xvector.tdnn.linear")
    params["tdnn_bn"], stats["tdnn_bn"] = _bn1d_sd(
        spk_sd, "xvector.tdnn.nonlinear.batchnorm"
    )
    for stage in (1, 2, 3):
        i = 0
        while f"xvector.block{stage}.tdnnd{i + 1}.linear1.weight" in spk_sd:
            base = f"xvector.block{stage}.tdnnd{i + 1}"
            lay_p: dict = {}
            lay_s: dict = {}
            lay_p["bn1"], lay_s["bn1"] = _bn1d_sd(
                spk_sd, f"{base}.nonlinear1.batchnorm"
            )
            lay_p["conv1"] = _convk_sd(spk_sd, f"{base}.linear1")
            lay_p["bn2"], lay_s["bn2"] = _bn1d_sd(
                spk_sd, f"{base}.nonlinear2.batchnorm"
            )
            lay_p["cam"] = {
                "linear_local": _convk_sd(
                    spk_sd, f"{base}.cam_layer.linear_local"
                ),
                "linear1": _convk_sd(
                    spk_sd, f"{base}.cam_layer.linear1", bias=True
                ),
                "linear2": _convk_sd(
                    spk_sd, f"{base}.cam_layer.linear2", bias=True
                ),
            }
            params[f"block{stage}_layer{i}"] = lay_p
            stats[f"block{stage}_layer{i}"] = lay_s
            i += 1
        params[f"transit{stage}_bn"], stats[f"transit{stage}_bn"] = _bn1d_sd(
            spk_sd, f"xvector.transit{stage}.nonlinear.batchnorm"
        )
        params[f"transit{stage}_conv"] = _convk_sd(
            spk_sd, f"xvector.transit{stage}.linear"
        )
    params["out_bn"], stats["out_bn"] = _bn1d_sd(
        spk_sd, "xvector.out_nonlinear.batchnorm"
    )
    params["dense"] = {
        "kernel": spk_sd["xvector.dense.linear.weight"][:, :, 0].T
    }
    # DenseLayer's batchnorm_ is affine-free: stats only
    stats["dense_bn"] = {
        "mean": spk_sd["xvector.dense.nonlinear.batchnorm.running_mean"],
        "var": spk_sd["xvector.dense.nonlinear.batchnorm.running_var"],
    }
    return params, stats


def port_reference_state(params: dict, batch_stats: Optional[dict] = None):
    """A map's JAX-layout tree (and the speaker encoder's statistics) ->
    the port's (parameters, buffers) state_dict parts, f32 tensors by
    name, through the weight bridge."""
    from wesep_tpu_torch.utils.jax_params import port_state_from_jax

    return port_state_from_jax(params, batch_stats)
