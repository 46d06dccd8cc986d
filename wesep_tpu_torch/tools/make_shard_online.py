"""Single-speaker shards for online mixing: tar files of {key}.spk and
{key}.<audio ext> members, and the list of their paths.

    python -m wesep_tpu_torch.tools.make_shard_online \
        --num_utts_per_shard 1000 wav.scp utt2spk shards_dir shards.list
"""

import argparse
import io
import logging
import multiprocessing
import os
import random
import tarfile

AUDIO_FORMAT_SETS = {"flac", "mp3", "m4a", "ogg", "opus", "wav", "wma"}


def write_tar_file(data_list, tar_file, index=0, total=1):
    """One shard of (key, speaker, audio path) entries."""
    logging.info("Processing %s %d/%d", tar_file, index, total)
    with tarfile.open(tar_file, "w") as tar:
        for key, spk, wav in data_list:
            data = spk.encode("utf8")
            info = tarfile.TarInfo(f"{key}.spk")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
            suffix = wav.rsplit(".", 1)[-1]
            if suffix not in AUDIO_FORMAT_SETS:
                raise ValueError(f"not an audio file: {wav}")
            with open(wav, "rb") as fin:
                payload = fin.read()
            winfo = tarfile.TarInfo(f"{key}.{suffix}")
            winfo.size = len(payload)
            tar.addfile(winfo, io.BytesIO(payload))


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="make online-mix shards")
    parser.add_argument("--num_utts_per_shard", type=int, default=1000)
    parser.add_argument("--num_threads", type=int, default=1)
    parser.add_argument("--prefix", default="shards")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("wav_scp")
    parser.add_argument("utt2spk")
    parser.add_argument("shards_dir")
    parser.add_argument("shards_list")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from wesep_tpu_torch.utils.file_utils import read_2columns_text

    wavs = read_2columns_text(args.wav_scp)
    utt2spk = read_2columns_text(args.utt2spk)
    data = [(k, utt2spk[k], wav) for k, wav in wavs.items()]
    if args.shuffle:
        random.shuffle(data)
    os.makedirs(args.shards_dir, exist_ok=True)
    num = args.num_utts_per_shard
    chunks = [data[i:i + num] for i in range(0, len(data), num)]
    shard_files = [os.path.join(args.shards_dir, f"{args.prefix}_{i:09d}.tar")
                   for i in range(len(chunks))]
    if args.num_threads > 1:
        with multiprocessing.Pool(processes=args.num_threads) as pool:
            jobs = [pool.apply_async(write_tar_file,
                                     (chunk, tar_file, i, len(chunks)))
                    for i, (chunk, tar_file) in enumerate(
                        zip(chunks, shard_files))]
            for job in jobs:
                job.get()
    else:
        for i, (chunk, tar_file) in enumerate(zip(chunks, shard_files)):
            write_tar_file(chunk, tar_file, i, len(chunks))
    with open(args.shards_list, "w") as f:
        for p in shard_files:
            f.write(p + "\n")


if __name__ == "__main__":
    main()
