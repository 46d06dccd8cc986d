"""Port parity: wesep_tpu_torch.ops.stft against wesep_tpu.ops.stft."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from wesep_tpu.ops import stft as jax_stft
from wesep_tpu_torch.ops import stft as port_stft

torch.set_num_threads(1)  # one intra-op thread per test worker


def _check_stft_istft(n_fft, hop, length, window):
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((2, length)).astype(np.float32) * 0.3
    jax_win = getattr(jax_stft, f"{window}_window")(n_fft)
    win = getattr(port_stft, f"{window}_window")(n_fft)
    want_re, want_im = jax_stft.stft(jnp.asarray(x), n_fft, hop, window=jax_win)
    got_re, got_im = port_stft.stft(torch.from_numpy(x), n_fft, hop,
                                    window=win)
    assert tuple(got_re.shape) == want_re.shape  # [B, T_frames, F]
    np.testing.assert_allclose(got_re.numpy(), np.asarray(want_re), atol=1e-4)
    np.testing.assert_allclose(got_im.numpy(), np.asarray(want_im), atol=1e-4)

    want = jax_stft.istft(want_re, want_im, n_fft, hop, window=jax_win,
                          length=length)
    got = port_stft.istft(got_re, got_im, n_fft, hop, window=win,
                          length=length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-4)  # round trip


@pytest.mark.parametrize("n_fft,hop,length", [(512, 128, 8000),
                                              (64, 16, 1001)])
def test_stft_istft_match_jax(n_fft, hop, length):
    _check_stft_istft(n_fft, hop, length, "hann")


# TF-GridNet's transform, with either window its conf may name
@pytest.mark.parametrize("window", ["hann", "hamming"])
def test_tfgridnet_stft_istft_match_jax(window):
    _check_stft_istft(128, 64, 16000, window)


def test_hann_window_matches_jax():
    np.testing.assert_allclose(
        port_stft.hann_window(512).numpy(),
        np.asarray(jax_stft.hann_window(512)), atol=1e-6,
    )


def test_hamming_window_matches_jax():
    np.testing.assert_allclose(
        port_stft.hamming_window(128).numpy(),
        np.asarray(jax_stft.hamming_window(128)), atol=1e-6,
    )
