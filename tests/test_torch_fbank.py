"""Port parity: wesep_tpu_torch.ops.fbank against wesep_tpu.ops.fbank.

The same numpy-seeded waveforms go through both packages on the CPU. The
mel banks agree exactly (the port keeps its own copy of the numpy code);
the features agree within rounding: the JAX package forms spectra as
matmuls against a DFT basis at Precision.HIGHEST, the port through
torch.fft / torch.stft, so log-mel values differ where a mel bin holds
little energy (the log magnifies the f32 rounding of small values).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from wesep_tpu.ops import fbank as jax_fbank
from wesep_tpu_torch.ops import fbank

torch.set_num_threads(1)  # one intra-op thread per test worker


def _wav(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    voice = sum(np.sin(2 * np.pi * 140.0 * k * t + k) / k for k in range(1, 6))
    return (scale * (voice + rng.standard_normal(shape))).astype(np.float32)


@pytest.mark.parametrize("args", [(80, 512, 16000.0), (40, 256, 8000.0),
                                  (80, 512, 16000.0, 100.0, -400.0),
                                  (64, 1024, 16000.0, 20.0, 7000.0)])
def test_kaldi_mel_banks_are_exact(args):
    got = fbank.kaldi_mel_banks(*args)
    np.testing.assert_array_equal(got, jax_fbank.kaldi_mel_banks(*args))
    assert got.shape == (args[1] // 2, args[0])


@pytest.mark.parametrize("args", [(257, 20.0, 8000.0, 80, 16000.0),
                                  (65, 20.0, 8000.0, 80, 16000.0),
                                  (129, 0.0, 4000.0, 40, 8000.0)])
def test_htk_mel_banks_are_exact(args):
    got = fbank.htk_mel_banks(*args)
    np.testing.assert_array_equal(got, jax_fbank.htk_mel_banks(*args))
    assert got.shape == (args[0], args[3])


@pytest.mark.parametrize("length", [400, 401, 8123, 16037])
@pytest.mark.parametrize("input_scale", [1.0, 32768.0])
def test_kaldi_fbank_matches_jax(length, input_scale):
    """Snip-edges framing (1 + (T - 400) // 160 frames), the symmetric
    Hamming window, DC removal and pre-emphasis: log-mel within 1e-4 of
    the largest magnitude (measured 4.2e-5)."""
    wav = _wav(length, (3, length))
    want = np.asarray(jax_fbank.kaldi_fbank(jnp.asarray(wav),
                                            input_scale=input_scale))
    got = fbank.kaldi_fbank(torch.from_numpy(wav), input_scale=input_scale)
    assert got.shape == (3, 1 + (length - 400) // 160, 80)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_kaldi_fbank_batch_single_and_options():
    """A row of a batch equals the row alone; a 1-D input gives 2-D
    features; the 8 kHz framing and other bins follow the arguments."""
    wav = _wav(1, (2, 8000))
    batch = fbank.kaldi_fbank(torch.from_numpy(wav), input_scale=32768.0)
    alone = fbank.kaldi_fbank(torch.from_numpy(wav[1]), input_scale=32768.0)
    assert alone.shape == batch.shape[1:]
    torch.testing.assert_close(alone, batch[1], atol=1e-5, rtol=1e-6)
    kw = dict(sample_rate=8000, num_mel_bins=40, frame_length_ms=32.0,
              frame_shift_ms=16.0, preemphasis=0.0, remove_dc_offset=False,
              low_freq=40.0, high_freq=-200.0)
    want = np.asarray(jax_fbank.kaldi_fbank(jnp.asarray(wav), **kw))
    got = fbank.kaldi_fbank(torch.from_numpy(wav), **kw).numpy()
    assert got.shape == (2, 1 + (8000 - 256) // 128, 40)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_kaldi_fbank_dither_follows_its_generator():
    """Dither noise comes from the generator it is given: the same seed
    gives the same features, no generator (or dither 0) none."""
    wav = torch.from_numpy(_wav(2, (2, 4000)))

    def run(seed, dither=1.0):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return fbank.kaldi_fbank(wav, dither=dither, generator=gen,
                                 input_scale=32768.0)

    plain = run(None)
    assert torch.equal(run(None, dither=1.0), plain)
    assert torch.equal(run(3, dither=0.0), plain)
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert (run(3) - plain).abs().max() > 0


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (128, 64)])
def test_melspectrogram_matches_jax(n_fft, hop):
    """Centre-padded STFT with the periodic Hamming window, HTK mel:
    within 1e-6 of the largest value."""
    wav = _wav(3, (2, 6001))
    want = np.asarray(jax_fbank.melspectrogram(jnp.asarray(wav), n_fft=n_fft,
                                               hop_length=hop))
    got = fbank.melspectrogram(torch.from_numpy(wav), n_fft=n_fft,
                               hop_length=hop)
    assert got.shape == want.shape == (2, 6001 // hop + 1, 80)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_fft,hop,length", [(512, 128, 16037),
                                              (128, 64, 4000)])
def test_speaker_feat_matches_jax(n_fft, hop, length):
    """The consistent frontend in f32: 99.9 % of the log-mel values within
    2e-4 and all within 1e-2 (a low-energy bin's log magnifies rounding;
    measured 4.5e-5 and 3.3e-4; 3.6e-3 on white noise); each mel bin's
    mean over time is 0. A bf16 waveform gives f32 features in both
    packages."""
    wav = _wav(4, (2, length))
    want = np.asarray(jax_fbank.speaker_feat(jnp.asarray(wav), n_fft=n_fft,
                                             hop_length=hop))
    got = fbank.speaker_feat(torch.from_numpy(wav), n_fft=n_fft,
                             hop_length=hop).numpy()
    assert got.shape == want.shape == (2, length // hop + 1, 80)
    err = np.abs(got - want)
    assert np.quantile(err, 0.999) <= 2e-4 and err.max() <= 1e-2
    np.testing.assert_allclose(got.mean(axis=1), 0.0, atol=1e-4)
    single = fbank.speaker_feat(torch.from_numpy(wav[0]), n_fft=n_fft,
                                hop_length=hop)
    torch.testing.assert_close(single, torch.from_numpy(got[0]), atol=1e-4,
                               rtol=1e-5)
    half = jax_fbank.speaker_feat(jnp.asarray(wav, jnp.bfloat16),
                                  n_fft=n_fft, hop_length=hop)
    got_half = fbank.speaker_feat(torch.from_numpy(wav).bfloat16(),
                                  n_fft=n_fft, hop_length=hop)
    assert half.dtype == jnp.float32 and got_half.dtype == torch.float32


@pytest.mark.parametrize("norm_var", [False, True])
def test_apply_cmvn_matches_jax(norm_var):
    feats = _wav(5, (2, 50, 80), scale=3.0) + 7.0
    want = np.asarray(jax_fbank.apply_cmvn(jnp.asarray(feats),
                                           norm_var=norm_var))
    got = fbank.apply_cmvn(torch.from_numpy(feats), norm_var=norm_var)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
