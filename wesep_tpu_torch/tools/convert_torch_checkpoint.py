"""Convert a checkpoint of the reference PyTorch toolkit (wenet-e2e/wesep)
into a port bundle.

Counterpart of wesep_tpu/tools/convert_torch_checkpoint.py, with the same
family dispatch by the config's model name (BSRNN / BSRNN_Multi,
BSRNN_Feats, DPCCN, TF-GridNet, ConvTasNet / SpEx+) and the same
fingerprints of a jointly trained wespeaker encoder (ECAPA-TDNN: per-split
BatchNorms in its Res2 stage, run it with `spk_args: {layout: wespeaker}`;
ResNet: numbered block convs and the seg_1 head; CAM++: the D-TDNN xvector
stack), which lands in `spk_model_net` (BSRNN family) or `spk_model`
(TF-GridNet, DPCCN) with its BatchNorm statistics. The maps are
utils/torch_port.py's, carried over the weight bridge; the bundle
(parameters as models[0], buffers as batch_stats[0]) is what bin/infer,
bin/average_model and `model_init` take.

    python -m wesep_tpu_torch.tools.convert_torch_checkpoint \
        --torch_ckpt avg_model.pt --config config.yaml --out avg_model.ckpt
"""

import argparse


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="reference .pt -> port "
                                     "bundle")
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--config", required=True,
                        help="the reference's config.yaml with model_args")
    parser.add_argument("--out", required=True)
    return parser.parse_args(argv)


def separator_params(name: str, margs: dict, sd: dict) -> dict:
    """The JAX-layout tree of the separator of model `name` (the config's
    model_args `margs`) from the reference state dict `sd`."""
    from wesep_tpu_torch.utils import torch_port as tp

    if name.startswith("BSRNN_Feats"):
        return tp.port_bsrnn_feats_state_dict(
            sd, sr=margs.get("sr", 16000), win=margs.get("win", 512),
            num_repeat=margs.get("num_repeat", 6),
            multi_fuse=margs.get("multi_fuse", False),
            use_spk_transform=margs.get("use_spk_transform", False),
            spk_fuse_type=margs.get("spk_fuse_type", "concat"))
    if name.startswith("BSRNN"):
        return tp.port_bsrnn_state_dict(
            sd, sr=margs.get("sr", 16000), win=margs.get("win", 512),
            num_repeat=margs.get("num_repeat", 6),
            multi_fuse=margs.get("multi_fuse", True),
            use_spk_transform=margs.get("use_spk_transform", True),
            spk_fuse_type=margs.get("spk_fuse_type", "concat"))
    if name.startswith("DPCCN"):
        return tp.port_dpccn_state_dict(sd)
    if name.startswith("TFGridNet"):
        return tp.port_tfgridnet_state_dict(sd)
    if name.startswith("ConvTasNet"):
        return tp.port_convtasnet_state_dict(sd, num_repeat=margs.get("R", 4))
    raise SystemExit(f"no converter for model family {name}")


def speaker_params(name: str, sd: dict):
    """(scope, params, batch_stats, family) of a jointly trained wespeaker
    encoder in `sd` (keys under `spk_model.`), or None when there is none;
    (scope, None, None, None) for encoder weights of no known layout."""
    from wesep_tpu_torch.utils import torch_port as tp

    spk_sd = {k[len("spk_model."):]: v for k, v in sd.items()
              if k.startswith("spk_model.")}
    if not spk_sd:
        return None
    # the JAX models' scope of the joint branch: BSRNN's spk_model_net,
    # DPCCN's and TF-GridNet's spk_model
    scope = "spk_model_net" if name.startswith("BSRNN") else "spk_model"
    if "layer2.se_res2block.1.bns.0.weight" in spk_sd:
        return (scope, *tp.port_wespeaker_ecapa_state_dict(spk_sd),
                "ECAPA")
    if "layer1.0.conv1.weight" in spk_sd and "seg_1.weight" in spk_sd:
        return (scope, *tp.port_wespeaker_resnet_state_dict(spk_sd),
                "ResNet")
    if "xvector.tdnn.linear.weight" in spk_sd:
        return (scope, *tp.port_wespeaker_campplus_state_dict(spk_sd),
                "CAMPPlus")
    return scope, None, None, None


def convert(torch_ckpt: str, config, out: str, log=print):
    """Convert `torch_ckpt` with the model of `config` (a path or a dict)
    into the port bundle `out` -> (parameters, buffers)."""
    import yaml

    from wesep_tpu_torch.train.checkpoint import save_checkpoint
    from wesep_tpu_torch.utils.torch_port import (
        load_torch_state_dict,
        port_reference_state,
    )

    if isinstance(config, str):
        with open(config) as f:
            config = yaml.safe_load(f)
    name = config["model"]["tse_model"]
    sd = load_torch_state_dict(torch_ckpt)
    params = separator_params(name, config["model_args"]["tse_model"], sd)
    batch_stats = None
    spk = speaker_params(name, sd)
    if spk is not None:
        scope, spk_params, spk_stats, family = spk
        if spk_params is None:
            log("NOTE: joint speaker-encoder weights present in the source "
                "but not a wespeaker ECAPA/ResNet/CAMPPlus layout; use "
                "spk_feat inference with a separately trained encoder or "
                "retrain the joint branch.")
        else:
            params[scope] = spk_params
            batch_stats = {scope: spk_stats}
            log(f"ported joint wespeaker-{family} speaker branch" + (
                "; run the model with spk_args: {layout: wespeaker}"
                if family == "ECAPA" else ""))
    state, buffers = port_reference_state(params, batch_stats)
    save_checkpoint(out, [state], batch_stats=[buffers] if buffers else None)
    n = sum(v.numel() for v in state.values())
    log(f"wrote {out} ({n / 1e6:.2f} M params)")
    return state, buffers


def main(argv=None):
    args = get_args(argv)
    convert(args.torch_ckpt, args.config, args.out)


if __name__ == "__main__":
    main()
