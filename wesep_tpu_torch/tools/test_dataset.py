"""Data-chain smoke check by hand: build the training chain over a data
list and print the first batches' shapes.

Counterpart of wesep_tpu/tools/test_dataset.py (the same chain settings).

    python -m wesep_tpu_torch.tools.test_dataset --data_type shard \
        --data_list data/train/shards.list \
        --spk2enroll data/train/spk2enroll.json
"""

import argparse
import json


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="data-chain smoke check")
    parser.add_argument("--data_type", default="shard",
                        choices=["shard", "raw"])
    parser.add_argument("--data_list", required=True)
    parser.add_argument("--spk2enroll", default=None)
    parser.add_argument("--online_mix", action="store_true")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_batches", type=int, default=3)
    parser.add_argument("--chunk_len", type=int, default=48000)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from wesep_tpu_torch.data import BatchLoader, Dataset, tse_collate_fn

    spk2embed, joint = None, False
    if args.spk2enroll:
        with open(args.spk2enroll) as f:
            spk2embed = json.load(f)
        joint = True
    configs = {
        "resample_rate": 16000,
        "shuffle": True,
        "shuffle_args": {"shuffle_size": 32},
        "chunk_len": args.chunk_len,
        "num_speakers": 2,
        "online_buffer_size": 64,
        "use_random_snr": True,
    }
    ds = Dataset(args.data_type, args.data_list, configs,
                 spk2embed_dict=spk2embed, state="train",
                 joint_training=joint, online_mix=args.online_mix, rank=0,
                 world_size=1)
    loader = BatchLoader(ds, batch_size=args.batch_size,
                         collate_fn=tse_collate_fn, prefetch=0)
    loader.set_epoch(0)
    shapes = []
    for i, batch in enumerate(loader):
        print(f"batch {i}:")
        shapes.append({})
        for k, v in batch.items():
            shape = getattr(v, "shape", f"len={len(v)}")
            shapes[-1][k] = shape
            print(f"  {k}: {shape}")
        if i + 1 >= args.num_batches:
            break
    return shapes


if __name__ == "__main__":
    main()
