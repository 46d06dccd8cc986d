"""Loss functions on tensors, batched, matching the JAX package's table.

Counterpart of wesep_tpu/train/losses.py: every loss is a plain function
`loss(est, ref) -> [B]` of per-example losses computed in f32; the mean is
taken in the train step.

  L1 / L2 / CE            mean absolute / squared error, cross entropy
  SISDR / SISNR           negative scale-invariant SDR in dB (zero-mean,
                          eps 1e-8)
  SNR                     negative SNR in dB
  STFT                    spectral convergence + log-magnitude, fft 1024 /
                          hop 256
  MultiResolutionSTFT     mean of STFT losses at ffts [1024, 2048, 512],
                          hops [120, 240, 50], windows [600, 1200, 240]
  PIT                     permutation-invariant negative SI-SNR
"""

import itertools
from typing import Callable, Dict, Sequence

import torch

from wesep_tpu_torch.ops.stft import hann_window, stft

EPS = 1e-8

__all__ = [
    "l1_loss", "l2_loss", "ce_loss", "si_sdr", "si_sdr_loss", "snr_loss",
    "stft_loss", "multi_resolution_stft_loss", "pit_si_snr_loss",
    "get_loss", "parse_loss", "is_ce",
]


def _flat2(x):
    return x.reshape(x.shape[0], -1).float()


def l1_loss(est, ref):
    return (_flat2(est) - _flat2(ref)).abs().mean(dim=-1)


def l2_loss(est, ref):
    return (_flat2(est) - _flat2(ref)).square().mean(dim=-1)


def ce_loss(logits, labels):
    """Cross entropy over integer class labels: logits [B, C], labels [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0]


def _zero_mean(est, ref, zero_mean):
    est, ref = est.float(), ref.float()
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        ref = ref - ref.mean(dim=-1, keepdim=True)
    return est, ref


def si_sdr(est, ref, zero_mean: bool = True, eps: float = EPS):
    """Scale-invariant SDR in dB, per example. est/ref: [B, T]."""
    est, ref = _zero_mean(est, ref, zero_mean)
    dot = (est * ref).sum(dim=-1, keepdim=True)
    s_target = dot * ref / ((ref * ref).sum(dim=-1, keepdim=True) + eps)
    e_noise = est - s_target
    ratio = (s_target.square().sum(dim=-1) + eps) / (
        e_noise.square().sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio)


def si_sdr_loss(est, ref):
    """Negative SI-SDR."""
    return -si_sdr(est, ref)


def snr_loss(est, ref, zero_mean: bool = True, eps: float = EPS):
    """Negative SNR in dB."""
    est, ref = _zero_mean(est, ref, zero_mean)
    num = (ref * ref).sum(dim=-1)
    den = (ref - est).square().sum(dim=-1)
    return -10.0 * torch.log10((num + eps) / (den + eps))


def _stft_mag(x, fft_size, hop, win_length):
    window = hann_window(win_length, device=x.device)
    re, im = stft(x.float(), fft_size, hop, window=window)
    # square root of the power clamped at 1e-8
    return torch.sqrt((re * re + im * im).clamp_min(1e-8))


def stft_loss(est, ref, fft_size: int = 1024, hop: int = 256,
              win_length: int = 1024, w_sc: float = 1.0,
              w_log_mag: float = 1.0):
    """Spectral convergence + log-STFT-magnitude loss, per example."""
    est_m = _stft_mag(est, fft_size, hop, win_length)
    ref_m = _stft_mag(ref, fft_size, hop, win_length)
    dims = tuple(range(1, est_m.dim()))
    sc = (ref_m - est_m).square().sum(dim=dims).sqrt() / (
        ref_m.square().sum(dim=dims).sqrt() + EPS)
    log_mag = (ref_m.log() - est_m.log()).abs().mean(dim=dims)
    return w_sc * sc + w_log_mag * log_mag


def multi_resolution_stft_loss(
    est, ref,
    fft_sizes: Sequence[int] = (1024, 2048, 512),
    hop_sizes: Sequence[int] = (120, 240, 50),
    win_lengths: Sequence[int] = (600, 1200, 240),
):
    """Mean of STFT losses over several resolutions."""
    total = 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        total = total + stft_loss(est, ref, n_fft, hop, win)
    return total / len(fft_sizes)


def pit_si_snr_loss(est, ref):
    """Permutation-invariant negative SI-SNR. est/ref: [B, S, T]; the best
    of the S! permutations per example."""
    n_spk = est.shape[1]
    losses = []
    for perm in itertools.permutations(range(n_spk)):
        per_spk = torch.stack(
            [si_sdr_loss(est[:, i], ref[:, p]) for i, p in enumerate(perm)],
            dim=-1)
        losses.append(per_spk.mean(dim=-1))
    return torch.stack(losses, dim=-1).min(dim=-1).values


_LOSSES: Dict[str, Callable] = {
    "L1": l1_loss,
    "L2": l2_loss,
    "CE": ce_loss,
    "SISDR": si_sdr_loss,
    "SISNR": si_sdr_loss,
    "SNR": snr_loss,
    "STFT": stft_loss,
    "MultiResolutionSTFT": multi_resolution_stft_loss,
    "PIT": pit_si_snr_loss,
}


def get_loss(name: str) -> Callable:
    if name not in _LOSSES:
        raise ValueError(f"Unknown loss {name!r}; have {sorted(_LOSSES)}")
    return _LOSSES[name]


def parse_loss(loss) -> list:
    """Name(s) -> list of loss functions."""
    if not isinstance(loss, (list, tuple)):
        loss = [loss]
    return [get_loss(name) for name in loss]


def is_ce(fn) -> bool:
    """True if `fn` is the CE loss (routed to spk_label in the train step)."""
    return fn is ce_loss
