"""The port's scoring stage against the JAX package's: cal_SNR,
batch_evaluation, bss_eval_sources with its permutation, STOI and ESTOI on
the same numpy arrays (rtol 1e-9), and bin/score's per-utterance files and
RESULTS against the JAX scoring() on the same scp lists."""

import os

import numpy as np
import pytest

from wesep_tpu.bin.score import scoring as jax_scoring
from wesep_tpu.utils import bss_eval as jax_bss
from wesep_tpu.utils import score as jax_score
from wesep_tpu.utils import stoi as jax_stoi
from wesep_tpu_torch.bin.score import main as score_main
from wesep_tpu_torch.bin.score import scoring
from wesep_tpu_torch.data.wav_io import write_wav
from wesep_tpu_torch.utils import bss_eval, score, stoi

RTOL = 1e-9


def _voices(rng, n, t, sr=16000):
    """n harmonic voices with noise and a pause, [n, t]."""
    time = np.arange(t) / sr
    out = []
    for _ in range(n):
        f0 = rng.uniform(90, 250)
        v = sum(np.sin(2 * np.pi * f0 * k * time + rng.uniform(0, 6)) / k
                for k in range(1, 5))
        v = 0.1 * v + 0.01 * rng.standard_normal(t)
        v[t // 3: t // 3 + t // 10] *= 0.01  # a quiet stretch for the VAD
        out.append(v)
    return np.stack(out)


def test_snr_and_batch_evaluation_match_jax():
    rng = np.random.default_rng(0)
    refs = list(rng.standard_normal((3, 4000)))
    ests = [r + 0.3 * rng.standard_normal(4000) for r in refs]
    for e, r in zip(ests, refs):
        np.testing.assert_allclose(score.cal_SNR(e, r),
                                   jax_score.cal_SNR(e, r), rtol=RTOL)
    for metric in (score.cal_SNR, score.cal_SISNR):
        np.testing.assert_allclose(
            score.batch_evaluation(metric, ests, refs),
            jax_score.batch_evaluation(metric, ests, refs), rtol=RTOL)
    assert score.batch_evaluation(score.cal_SNR, ests, refs, n_jobs=2) == \
        score.batch_evaluation(score.cal_SNR, ests, refs)


@pytest.mark.parametrize("swap", [False, True])
def test_bss_eval_sources_matches_jax(swap):
    """Two sources, estimates in either order: the permutation and every
    ratio as the JAX function's."""
    rng = np.random.default_rng(1 + swap)
    ref = _voices(rng, 2, 8000)
    est = ref + 0.2 * ref[::-1] + 0.05 * rng.standard_normal(ref.shape)
    if swap:
        est = est[::-1]
    got = bss_eval.bss_eval_sources(ref, est)
    want = jax_bss.bss_eval_sources(ref, est)
    np.testing.assert_array_equal(got[3], want[3])
    assert list(got[3]) == ([1, 0] if swap else [0, 1])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=RTOL)


@pytest.mark.parametrize("fs", [16000, 8000])
def test_stoi_and_estoi_match_jax(fs):
    rng = np.random.default_rng(3)
    ref = _voices(rng, 1, fs)[0]
    est = ref + 0.1 * rng.standard_normal(fs)
    for extended in (False, True):
        got = stoi.stoi(ref, est, fs, extended=extended)
        want = jax_stoi.stoi(ref, est, fs, extended=extended)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(stoi.estoi(ref, est, fs),
                               jax_stoi.estoi(ref, est, fs), rtol=RTOL)
    assert np.isnan(stoi.stoi(ref[:500], est[:500], fs))


def _scp_lists(root, rng, keys):
    """Reference and estimate wavs of two speakers per key, and their
    scp lists (the estimates a few samples shorter, as decoding leaves
    them)."""
    paths = {}
    for i in (1, 2):
        for kind in ("ref", "inf"):
            paths[(kind, i)] = os.path.join(root, f"{kind}{i}.scp")
    lines = {k: [] for k in paths}
    for n, key in enumerate(keys):
        ref = _voices(rng, 2, 12000 + 800 * n)
        est = ref[::-1] * 0.2 + ref + 0.02 * rng.standard_normal(ref.shape)
        for i in (1, 2):
            for kind, wav in (("ref", ref[i - 1]),
                              ("inf", est[i - 1][:-37])):
                path = os.path.join(root, f"{key}_{kind}{i}.wav")
                write_wav(path, wav.astype(np.float32), 16000)
                lines[(kind, i)].append(f"{key} {path}\n")
    for k, p in paths.items():
        with open(p, "w") as f:
            f.writelines(lines[k])
    key_file = os.path.join(root, "keys.scp")
    with open(key_file, "w") as f:
        f.writelines(f"{k} x\n" for k in keys)
    return key_file, [paths[("ref", i)] for i in (1, 2)], \
        [paths[("inf", i)] for i in (1, 2)]


def _parse(path):
    with open(path) as f:
        return [line.split() for line in f]


def test_bin_score_matches_jax_scoring(tmp_path):
    rng = np.random.default_rng(4)
    key_file, ref_scp, inf_scp = _scp_lists(str(tmp_path), rng,
                                            ["u0", "u1", "u2"])
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    score_main(["--output_dir", str(ours), "--key_file", key_file,
                "--ref_scp", *ref_scp, "--inf_scp", *inf_scp])
    want = jax_scoring(str(theirs), key_file, ref_scp, inf_scp)
    got = scoring(str(tmp_path / "port2"), key_file, ref_scp, inf_scp)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[m] for m in got],
                               [want[m] for m in want], rtol=RTOL)
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names
    assert len(names) == 6 * 2 + 1
    for name in names:
        a, b = _parse(ours / name), _parse(theirs / name)
        assert [r[0] for r in a] == [r[0] for r in b]
        np.testing.assert_allclose([float(r[-1]) for r in a],
                                   [float(r[-1]) for r in b], rtol=RTOL)
    with pytest.raises(NotImplementedError, match="DNSMOS"):
        scoring(str(tmp_path / "x"), key_file, ref_scp, inf_scp,
                use_dnsmos=True)
