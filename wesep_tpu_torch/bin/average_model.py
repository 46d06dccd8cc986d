"""Checkpoint averaging: the parameters of the last N (or the listed) epoch
checkpoints, averaged into one bundle that bin/infer decodes from.

    python -m wesep_tpu_torch.bin.average_model \\
        --dst_model exp/.../avg_model.ckpt --src_path exp/.../models \\
        --num 2 [--epochs 8 9] [--min_epoch 5]
"""

import argparse


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="average model")
    parser.add_argument("--dst_model", required=True)
    parser.add_argument("--src_path", required=True,
                        help="dir containing checkpoint_<N>.ckpt")
    parser.add_argument("--num", type=int, default=2,
                        help="average the last N epochs")
    parser.add_argument("--epochs", type=int, nargs="*", default=None,
                        help="explicit epoch list")
    parser.add_argument("--min_epoch", type=int, default=0)
    parser.add_argument("--max_epoch", type=int, default=65536)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from wesep_tpu_torch.train.checkpoint import (
        average_checkpoints,
        find_epoch_checkpoints,
        load_checkpoint,
        save_checkpoint,
    )

    ckpts = [(e, p) for e, p in find_epoch_checkpoints(args.src_path)
             if args.min_epoch <= e <= args.max_epoch]
    if args.epochs:
        selected = [p for e, p in ckpts if e in set(args.epochs)]
    else:
        selected = [p for _, p in ckpts[-args.num:]]
    if not selected:
        raise SystemExit(f"no checkpoints found in {args.src_path}")
    print(f"averaging {len(selected)} checkpoints:")
    for p in selected:
        print(" ", p)
    avg = average_checkpoints(selected)
    # carry batch_stats and step from the newest checkpoint
    newest = load_checkpoint(selected[-1])
    save_checkpoint(args.dst_model, [avg],
                    batch_stats=newest.get("batch_stats") or None,
                    step=newest.get("step", 0))
    print("saved", args.dst_model)


if __name__ == "__main__":
    main()
