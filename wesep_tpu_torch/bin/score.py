"""Scoring entry point: BSS-eval, STOI / ESTOI and SI-SNR (and PESQ).

Counterpart of wesep_tpu/bin/score.py with the same output: for every
utterance of the key file, bss_eval_sources with permutation
(utils/bss_eval.py), then per speaker SDR, SIR, SAR, SI-SNR, STOI and
ESTOI (utils/stoi.py) and, with --use_pesq, PESQ (utils/score.cal_PESQ),
written as kaldi-style text files {METRIC}_spk{i} keyed by utterance, and
a RESULTS file with each metric's average over its finite values. It runs
on the host (numpy and scipy). DNSMOS needs ONNX models this repo does
not have: --use_dnsmos raises.

    python -m wesep_tpu_torch.bin.score --output_dir out --key_file keys.scp \
        --ref_scp ref1.scp ref2.scp --inf_scp inf1.scp inf2.scp [--use_pesq]
"""

import argparse
import logging
import os
from collections import defaultdict

import numpy as np

METRICS = ("STOI", "ESTOI", "SI_SNR", "SDR", "SAR", "SIR")


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="wesep_tpu_torch score")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--key_file", required=True)
    parser.add_argument("--ref_scp", nargs="+", required=True)
    parser.add_argument("--inf_scp", nargs="+", required=True)
    parser.add_argument("--use_pesq", action="store_true")
    parser.add_argument("--use_dnsmos", action="store_true")
    parser.add_argument("--log_level", default="INFO")
    return parser.parse_args(argv)


def _read_pair(ref_maps, inf_maps, key):
    """Each speaker's reference and estimate of `key`, all cut to the
    shortest of them -> (ref [S, T], inf [S, T], sample rate)."""
    from wesep_tpu_torch.data.wav_io import read_wav

    refs, infs, sample_rate = [], [], None
    for ref_map, inf_map in zip(ref_maps, inf_maps):
        r, sr = read_wav(ref_map[key])
        e, sr2 = read_wav(inf_map[key])
        if sr != sr2:
            raise ValueError(f"{key}: reference at {sr} Hz, estimate at "
                             f"{sr2} Hz")
        sample_rate = sr
        refs.append(r[0])
        infs.append(e[0])
    t = min(min(len(r) for r in refs), min(len(e) for e in infs))
    return (np.stack([r[:t] for r in refs]), np.stack([e[:t] for e in infs]),
            sample_rate)


def scoring(output_dir: str, key_file: str, ref_scp, inf_scp,
            use_pesq: bool = False, use_dnsmos: bool = False):
    """Score every utterance of `key_file`; write {METRIC}_spk{i} and
    RESULTS under `output_dir` -> {metric: average}."""
    from wesep_tpu_torch.utils.bss_eval import bss_eval_sources
    from wesep_tpu_torch.utils.file_utils import read_2columns_text
    from wesep_tpu_torch.utils.score import cal_PESQ, cal_SISNR
    from wesep_tpu_torch.utils.stoi import stoi

    if use_dnsmos:
        raise NotImplementedError(
            "DNSMOS needs its ONNX models and onnxruntime, which this port "
            "does not carry; score without --use_dnsmos")
    if len(ref_scp) != len(inf_scp):
        raise ValueError(f"{len(ref_scp)} reference lists but "
                         f"{len(inf_scp)} estimate lists")
    num_spk = len(ref_scp)
    with open(key_file, encoding="utf-8") as f:
        keys = [line.split(maxsplit=1)[0] for line in f if line.strip()]
    ref_maps = [read_2columns_text(p) for p in ref_scp]
    inf_maps = [read_2columns_text(p) for p in inf_scp]

    os.makedirs(output_dir, exist_ok=True)
    metrics = list(METRICS) + (["PESQ"] if use_pesq else [])
    files = {(m, i): open(os.path.join(output_dir, f"{m}_spk{i + 1}"), "w",
                          encoding="utf-8")
             for m in metrics for i in range(num_spk)}
    sums, counts = defaultdict(float), defaultdict(int)
    try:
        for n, key in enumerate(keys):
            logging.info("[%d] Scoring %s", n, key)
            ref, inf, sample_rate = _read_pair(ref_maps, inf_maps, key)
            sdr, sir, sar, perm = bss_eval_sources(ref, inf)
            for i in range(num_spk):
                p = int(perm[i])
                row = {
                    "SDR": sdr[i], "SIR": sir[i], "SAR": sar[i],
                    "SI_SNR": cal_SISNR(inf[i], ref[p]),
                    "STOI": stoi(ref[p], inf[i], sample_rate),
                    "ESTOI": stoi(ref[p], inf[i], sample_rate,
                                  extended=True),
                }
                if use_pesq:
                    pq = cal_PESQ(inf[i], ref[p], sample_rate)
                    row["PESQ"] = pq if pq is not None else float("nan")
                for m, v in row.items():
                    files[(m, i)].write(f"{key} {v:.4f}\n")
                    if np.isfinite(v):
                        sums[m] += v
                        counts[m] += 1
    finally:
        for f in files.values():
            f.close()

    averages = {m: sums[m] / max(counts[m], 1) for m in metrics}
    with open(os.path.join(output_dir, "RESULTS"), "w") as f:
        for m in metrics:
            f.write(f"{m}: {averages[m]:.4f}\n")
            logging.info("%s: %.4f", m, averages[m])
    return averages


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=args.log_level)
    scoring(args.output_dir, args.key_file, args.ref_scp, args.inf_scp,
            use_pesq=args.use_pesq, use_dnsmos=args.use_dnsmos)


if __name__ == "__main__":
    main()
