"""Premixed shards: tar files of `num_utts_per_shard` mixtures, each as the
members {key}.spk{i} (speaker ids), {key}.<ext> (the mixture) and
{key}_spk{i}.<ext> (its clean sources), and the list of their paths.

Counterpart of wesep_tpu/tools/make_shard_list_premix.py, with the same
tar members in the same order. Inputs: the mixtures' wav.scp, one scp of
clean sources per speaker (comma-separated) and a file of "utt spk1 spk2"
lines.

    python -m wesep_tpu_torch.tools.make_shard_list_premix \
        --num_utts_per_shard 1000 --num_threads 8 \
        wav.scp spk1.scp,spk2.scp utt2spks shards_dir shards.list
"""

import argparse
import io
import logging
import multiprocessing
import os
import random
import tarfile

AUDIO_FORMAT_SETS = {"flac", "mp3", "m4a", "ogg", "opus", "wav", "wma"}


def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def write_tar_file(data_list, tar_file, index=0, total=1):
    """One shard of (key, speaker ids, [mixture, source 1, ...]) entries."""
    logging.info("Processing %s %d/%d", tar_file, index, total)
    with tarfile.open(tar_file, "w") as tar:
        for key, spks, wavs in data_list:
            for spk_idx, spk in enumerate(spks, start=1):
                _add(tar, f"{key}.spk{spk_idx}", spk.encode("utf8"))
            for wav_idx, wav in enumerate(wavs):
                suffix = wav.rsplit(".", 1)[-1]
                if suffix not in AUDIO_FORMAT_SETS:
                    raise ValueError(f"not an audio file: {wav}")
                with open(wav, "rb") as fin:
                    payload = fin.read()
                name = f"{key}.{suffix}" if wav_idx == 0 \
                    else f"{key}_spk{wav_idx}.{suffix}"
                _add(tar, name, payload)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="make premixed shards")
    parser.add_argument("--num_utts_per_shard", type=int, default=1000)
    parser.add_argument("--num_threads", type=int, default=1)
    parser.add_argument("--prefix", default="shards")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("wav_scp", help="mixture wav.scp")
    parser.add_argument("spk_scps",
                        help="comma-separated clean-source scps")
    parser.add_argument("utt2spks",
                        help="utt -> space-separated speaker ids")
    parser.add_argument("shards_dir")
    parser.add_argument("shards_list")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from wesep_tpu_torch.utils.file_utils import read_2columns_text

    mix = read_2columns_text(args.wav_scp)
    spk_wav_maps = [read_2columns_text(p) for p in args.spk_scps.split(",")]
    utt2spks = {k: v.split()
                for k, v in read_2columns_text(args.utt2spks).items()}
    data = [(key, utt2spks[key], [wav] + [m[key] for m in spk_wav_maps])
            for key, wav in mix.items()]
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
