"""Trace one model's train step at its bench envelope.

Counterpart of tools/trace_step.py: the port's train step
(`train/trainer.make_train_step`: bf16 compute, f32 parameters, SI-SDR on
the envelope's loss table, the per-parameter clip, +wd*p, Adam and the JAX
tool's exponential schedule) on seeded random rows, 3 warm-up steps, then
`--steps` steps inside `utils/profiling.trace`, whose Chrome trace
`op_profile` reads:

    python -m wesep_tpu_torch.tools.trace_step --model bsrnn --out /tmp/tr
    python -m wesep_tpu_torch.tools.op_profile /tmp/tr --top 30

ENVELOPES is the port's copy of tools/bench_models.ENVELOPES' first six
(pBSRNN batch 16, SpEx+ 8, DPCCN 8 on both conv routes, TF-GridNet 2, all
3 s at 16 kHz). It runs on the card unless given `--device cpu`.
"""

import argparse

# reference training envelopes: (model ctor name, kwargs, batch, note)
# batch sizes per the v2 confs (A800 settings), 3 s chunks @16 kHz.
ENVELOPES = {
    "bsrnn": dict(
        model="BSRNN",
        args=dict(spk_emb_dim=256, sr=16000, win=512, stride=128,
                  feature_dim=128, num_repeat=6, use_spk_transform=False,
                  spk_fuse_type="multiply", multi_fuse=False,
                  joint_training=False, remat=False),
        batch=16,
    ),
    "spexplus": dict(
        model="ConvTasNet",
        args=dict(L=20, N=256, X=8, R=4, B=256, H=512, P=3,
                  norm="gLN", activate="relu", causal=False,
                  skip_con=False, spk_emb_dim=256,
                  spk_fuse_type="concatConv", encoder_type="Multi",
                  decoder_type="Multi", joint_training=False),
        batch=8,
        # multi-scale decoder: SI-SDR on est1/est2/est3, 0.8/0.1/0.1
        # (confs/spexplus.yaml:27-30)
        loss_posi=((0, 1, 2),),
        loss_weight=((0.8, 0.1, 0.1),),
    ),
    "dpccn": dict(
        model="DPCCN",
        args=dict(spk_emb_dim=256, win=512, stride=128,
                  joint_training=False),
        batch=8,
    ),
    "tfgridnet": dict(
        model="TFGridNet",
        args=dict(n_srcs=1, sr=16000, n_fft=128, stride=64, n_layers=6,
                  lstm_hidden_units=192, attn_n_head=4,
                  attn_approx_qk_dim=512, emb_dim=48, emb_ks=4, emb_hs=1,
                  spk_emb_dim=256, spk_fuse_type="multiply",
                  joint_training=False, remat=False),
        batch=2,
    ),
}
# the JAX package's patch-matmul route, which the port runs as "xla"
ENVELOPES["dpccn_patch"] = dict(
    model="DPCCN",
    args={**ENVELOPES["dpccn"]["args"], "conv_impl": "patch"},
    batch=8,
)
# fused conv+ELU+IN blocks (K5/K5b)
ENVELOPES["dpccn_pallas"] = dict(
    model="DPCCN",
    args={**ENVELOPES["dpccn"]["args"], "conv_impl": "pallas"},
    batch=8,
)

CHUNK_SEC = 3.0
SR = 16000
WARMUP_STEPS = 3


def envelope_batch(batch_n: int, samples: int, seed: int = 0) -> dict:
    """The JAX tool's random rows (numpy, seeded): mixture, target,
    embedding, label."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "wav_mix": rng.standard_normal((batch_n, samples)).astype(
            np.float32) * 0.1,
        "wav_targets": rng.standard_normal((batch_n, samples)).astype(
            np.float32) * 0.1,
        "spk_embeds": rng.standard_normal((batch_n, 256)).astype(
            np.float32),
        "spk_label": np.zeros((batch_n,), np.int32),
    }


def trace_step(model_name: str, out: str, steps: int = 3, device=None,
               before_trace=None) -> str:
    """Train `model_name` at its envelope for WARMUP_STEPS steps, call
    `before_trace()` if given, then trace `steps` steps into `out`; -> the
    Chrome trace's path."""
    import torch

    from wesep_tpu_torch.device import resolve_device
    from wesep_tpu_torch.models import get_model
    from wesep_tpu_torch.train.losses import si_sdr_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        batch_to_device,
        make_optimizer,
        make_train_step,
    )
    from wesep_tpu_torch.utils.profiling import trace

    device = resolve_device(device)
    env = ENVELOPES[model_name]
    torch.manual_seed(0)
    model = get_model(env["model"])(**env["args"])
    model.to(device)
    host = envelope_batch(env["batch"], int(CHUNK_SEC * SR))
    data = batch_to_device(host, device)
    sched = exponential_decrease(
        num_epochs=150, epoch_iter=1000, initial_lr=1e-3,
        final_lr=2.5e-5, warm_up_epoch=0)
    state = TrainState(model, make_optimizer(model, sched, weight_decay=1e-4,
                                             clip_grad=5.0))
    step = make_train_step([si_sdr_loss],
                           loss_posi=env.get("loss_posi", ((0,),)),
                           loss_weight=env.get("loss_weight", ((1.0,),)),
                           compute_dtype=torch.bfloat16)
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, data)
        float(metrics["loss"])
    if before_trace is not None:
        before_trace()
    with trace(out) as path:
        for _ in range(steps):
            state, metrics = step(state, data)
        float(metrics["loss"])
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="spexplus",
                        choices=sorted(ENVELOPES))
    parser.add_argument("--out", default="/tmp/wesep_trace")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    path = trace_step(args.model, args.out, args.steps, args.device)
    print(f"trace written to {path}; summarize with:")
    print(f"  python -m wesep_tpu_torch.tools.op_profile {args.out} --top 30")


if __name__ == "__main__":
    main()
