"""Build a noise store: a .pack file (default) or an LMDB directory.

Keys come from the scp file; MUSAN-style keys (`noise_*`, `speech_*`,
`music_*`) choose the SNR range of host noise augmentation
(data/processor._add_noise_to). `--format lmdb` needs the lmdb package.

    python -m wesep_tpu_torch.tools.make_noise_db noise.scp out.pack
"""

import argparse


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="make noise db")
    parser.add_argument("in_scp_file")
    parser.add_argument("out_path")
    parser.add_argument("--format", choices=("pack", "lmdb"),
                        default="pack")
    return parser.parse_args(argv)


def write_lmdb(keys, paths, out_path):
    """An LMDB directory: one value per key and the pickled key list under
    `__keys__`."""
    import math
    import pickle

    try:
        import lmdb
    except ImportError as e:
        raise SystemExit("--format lmdb needs the lmdb package, which is not "
                         "installed; the default --format pack needs "
                         "nothing") from e
    db = lmdb.open(out_path, map_size=int(math.pow(1024, 4)))
    with db.begin(write=True) as txn:
        for key, wav in zip(keys, paths):
            with open(wav, "rb") as f:
                txn.put(key.encode(), f.read())
        txn.put(b"__keys__", pickle.dumps(keys))
    db.sync()
    db.close()


def main(argv=None):
    args = get_args(argv)
    from wesep_tpu_torch.data.noise_store import build_pack
    from wesep_tpu_torch.utils.file_utils import read_2columns_text

    entries = read_2columns_text(args.in_scp_file)
    keys = list(entries.keys())
    paths = [entries[k] for k in keys]
    if args.format == "pack":
        build_pack(paths, args.out_path, keys)
    else:
        write_lmdb(keys, paths, args.out_path)
    print(f"wrote {len(keys)} noise entries to {args.out_path}")


if __name__ == "__main__":
    main()
