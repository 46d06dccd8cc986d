"""Ahead-of-time export of the served forward with torch.export.

Counterpart of wesep_tpu/bin/export.py: the model's forward at static
shapes (mix [batch, samples]; the enrollment cue [batch, frames, dim] of
fbank for a joint model with speaker features, [batch, samples] of wav for
another joint model, [batch, spk_emb_dim] of embedding otherwise; the
defaults are the JAX package's, mix [2, 81280] and fbank [2, 300, 80])
becomes a torch.export program, written to `output_dir` as

  * model.pt2: the program (torch.export.save; it holds the weights too);
  * model.ckpt: the weights as a port bundle;
  * export.json: the JAX package's manifest keys (model, mix_shape,
    enroll_shape, speaker_feat, joint_training, sample_rate, platforms),
    `platforms` the device type it was exported on;

then the program is loaded back and must give the eager forward's output
bit for bit on seeded inputs. runtime_host.py serves such a dir.

The served forward returns the first estimate (the short-window one of a
multi-scale model). It runs with no gradient, so every kernel call site
goes through its operator (`wesep::bilstm_layer`, `wesep::bilstm_fused`,
`wesep::lstm_fused`, `wesep::bilstm_layer_unfold`, `wesep::tcn_block_gln`,
`wesep::conv2d_block_in`): the program holds them as nodes, which launch
the kernels on CUDA tensors and run their plain versions on the CPU. The
route of each layer (WESEP_LSTM_UNFOLD, WESEP_LSTM_LAYER, a DPCCN's
conv_impl) is fixed at export. Export on the card (the default) for the
card: the program's tensors are on its device. TensorFlow's SavedModel,
which the JAX package also writes, has no place here: --format savedmodel
or both raises.

    python -m wesep_tpu_torch.bin.export --config exp/config.yaml \
        --checkpoint exp/avg_model.ckpt --output_dir exp/export
"""

import argparse
import json
import os

import torch

__all__ = ["ServedForward", "build_served", "export_model", "load_program",
           "enroll_shape"]


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="wesep_tpu_torch export")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--samples", type=int, default=81280)
    parser.add_argument("--enroll_frames", type=int, default=300)
    parser.add_argument("--enroll_dim", type=int, default=80)
    parser.add_argument("--format", default="pt2",
                        choices=["pt2", "savedmodel", "both"])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


class ServedForward(torch.nn.Module):
    """(mix, enroll) -> the model's first estimate [B, T]."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, mix, enroll):
        est = self.model(mix, enroll)[0]
        if isinstance(est, (list, tuple)):
            est = est[0]
        return est


def build_served(configs: dict, checkpoint: str, device) -> ServedForward:
    """The config's model with the bundle's weights, in eval mode with no
    gradient, on `device`."""
    from wesep_tpu_torch.models import get_model
    from wesep_tpu_torch.train.checkpoint import load_checkpoint, model_state

    model_args = dict(configs["model_args"]["tse_model"])
    model_args.pop("spk_model_init", None)
    model = get_model(configs["model"]["tse_model"])(**model_args)
    model.load_state_dict(model_state(load_checkpoint(checkpoint)))
    model.to(device).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return ServedForward(model)


def enroll_shape(model_args: dict, batch: int, samples: int,
                 enroll_frames: int, enroll_dim: int):
    """The enrollment cue's shape, as the JAX package's export picks it."""
    if model_args.get("joint_training", False):
        if model_args.get("spk_feat", False):
            return (batch, enroll_frames, enroll_dim)
        return (batch, samples)
    return (batch, model_args.get("spk_emb_dim", 256))


def load_program(output_dir: str):
    """The exported program's module (the operators are registered by
    importing the kernel wrappers, as any model import does)."""
    import wesep_tpu_torch.ops.rnn  # noqa: F401
    from wesep_tpu_torch.ops import cuda_conv2d, cuda_tcn  # noqa: F401

    return torch.export.load(os.path.join(output_dir, "model.pt2")).module()


def export_model(config, checkpoint, output_dir, batch=2, samples=81280,
                 enroll_frames=300, enroll_dim=80, fmt="pt2", device=None):
    """Export; -> (output_dir, the ExportedProgram)."""
    from wesep_tpu_torch.device import resolve_device
    from wesep_tpu_torch.train.checkpoint import save_checkpoint, split_state
    from wesep_tpu_torch.utils.config import parse_config_or_kwargs

    if fmt != "pt2":
        raise NotImplementedError(
            f"--format {fmt}: a TensorFlow SavedModel has no place in the "
            "PyTorch port; export the torch.export program (--format pt2)")
    device = resolve_device(device)
    configs = parse_config_or_kwargs(config)
    served = build_served(configs, checkpoint, device)
    model_args = configs["model_args"]["tse_model"]
    e_shape = enroll_shape(model_args, batch, samples, enroll_frames,
                           enroll_dim)
    mix = torch.zeros(batch, samples, device=device)
    enroll = torch.zeros(e_shape, device=device)
    with torch.no_grad():
        program = torch.export.export(served, (mix, enroll))
    os.makedirs(output_dir, exist_ok=True)
    torch.export.save(program, os.path.join(output_dir, "model.pt2"))
    params, buffers = split_state(served.model)
    save_checkpoint(os.path.join(output_dir, "model.ckpt"), [params],
                    batch_stats=[buffers])
    manifest = {
        "model": configs["model"]["tse_model"],
        "mix_shape": [batch, samples],
        "enroll_shape": list(e_shape),
        "speaker_feat": bool(model_args.get("spk_feat", False)),
        "joint_training": bool(model_args.get("joint_training", False)),
        "sample_rate": configs["dataset_args"].get("resample_rate", 16000),
        "platforms": [device.type],
    }
    with open(os.path.join(output_dir, "export.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    # round trip: the loaded program against the eager forward, on seeded
    # inputs (zeros give some models' norms nothing to normalise)
    gen = torch.Generator().manual_seed(0)
    mix = (0.1 * torch.randn(mix.shape, generator=gen)).to(device)
    enroll = torch.randn(enroll.shape, generator=gen).to(device)
    restored = load_program(output_dir)
    with torch.no_grad():
        want = served(mix, enroll)
        got = restored(mix, enroll)
    if tuple(got.shape) != (batch, samples) or not torch.equal(got, want):
        raise RuntimeError(
            f"the loaded program differs from the eager forward: shape "
            f"{tuple(got.shape)}, max |diff| "
            f"{float((got - want).abs().max()) if got.shape == want.shape else None}")
    print(f"exported to {output_dir} ({device.type})")
    return output_dir, program


def main(argv=None):
    args = get_args(argv)
    export_model(args.config, args.checkpoint, args.output_dir, args.batch,
                 args.samples, args.enroll_frames, args.enroll_dim,
                 fmt=args.format, device=args.device)


if __name__ == "__main__":
    main()
