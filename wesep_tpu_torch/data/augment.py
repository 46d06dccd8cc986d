"""Batched simulation on the device: FRAM-RIR reverb, SNR mixing, noise.

Counterpart of wesep_tpu/data/augment.py in torch ops on the batch's
device (the train step calls it on the card): the host only decodes,
chunks and pairs audio, and one call simulates a whole batch. The math is
the JAX package's batched FRAM-RIR (arXiv:2304.08052): a fixed image
budget with a random count of valid images, a fixed RIR length at the
largest RT60 (taps past a sample's own length go to a trash slot), a
linear-interpolation fractional-delay scatter at 8x the sample rate, and
one static FIR that decimates and highpasses at 80 Hz.

Each random function is split in two: a draw (`draw_rirs`,
`draw_augment`), which takes an explicit torch.Generator and returns the
named random tensors, and a deterministic part (`sample_rirs`,
`reverberate`, `snr_mix`, `add_noise_snr`, `augment_batch`), which takes
those tensors. A generator on the batch's device seeded from (seed, step,
microbatch) (`step_generator`) repeats a step's simulation on resume.

Sums run in a fixed order, so a call repeats bit for bit on the card: the
scatter of image taps sorts the taps by position (a stable sort) and sums
each position's run in f64; the FIR runs as a cuDNN cross-correlation
with deterministic algorithms and TF32 off.
"""

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["RirConfig", "step_generator", "draw_rirs", "image_taps",
           "sample_rirs", "fft_convolve", "reverberate", "snr_mix",
           "add_noise_snr", "draw_augment", "take_rows", "augment_batch"]

_VELOCITY = 340.0


class RirConfig(NamedTuple):
    sr: int = 16000
    num_src: int = 2
    rt60: Tuple[float, float] = (0.1, 0.7)
    room_lo: Tuple[float, float, float] = (3.0, 3.0, 2.5)
    room_hi: Tuple[float, float, float] = (10.0, 6.0, 4.0)
    mic_dist: Tuple[float, float] = (0.2, 5.0)
    n_image: Tuple[int, int] = (1024, 4096)
    a: float = -2.0
    b: float = 2.0
    tau: float = 0.25
    oversample: int = 8
    min_dis_wall: float = 0.5


@functools.lru_cache(maxsize=8)
def _decim_fir(oversample: int, sr: int) -> np.ndarray:
    """The static FIR: the decimation's anti-alias lowpass (0.9 of the
    target Nyquist) convolved with an 80 Hz highpass, 16 * oversample + 1
    taps each, as float32."""
    from scipy import signal as sp

    numtaps = 16 * oversample + 1
    hi_sr = sr * oversample
    lp = sp.firwin(numtaps, 0.9 * (sr / 2), fs=hi_sr)
    hp = sp.firwin(numtaps, 80.0, fs=hi_sr, pass_zero=False)
    return np.convolve(lp, hp).astype(np.float32)


def step_generator(seed: int, step: int, micro: int,
                   device) -> torch.Generator:
    """A generator on `device` seeded from (seed, step, microbatch)."""
    state = np.random.SeedSequence([int(seed), int(step), int(micro)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0] >> 1))
    return gen


def _uniform(gen, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def draw_rirs(gen: torch.Generator, batch: int, cfg: RirConfig) -> dict:
    """The random tensors of `sample_rirs`, on the generator's device: the
    room [B, 3], rt60 [B, 1, 1], the microphone's and the sources' uniform
    positions in the room's interior ([B, 3], [B, ns, 3], in [0, 1)), the
    count of valid images [B, 1, 1] in [n_image[0], n_image[1]], the
    distance draws u [B, ns, n_img] in [0, 1) and the reflection-count
    perturbation pert [B, ns, n_img] in [a, b)."""
    ns, n_img = cfg.num_src, cfg.n_image[1]
    lo = torch.tensor(cfg.room_lo, device=gen.device)
    hi = torch.tensor(cfg.room_hi, device=gen.device)
    return {
        "room": _uniform(gen, (batch, 3)) * (hi - lo) + lo,
        "rt60": _uniform(gen, (batch, 1, 1), *cfg.rt60),
        "mic_pos": _uniform(gen, (batch, 3)),
        "src": _uniform(gen, (batch, ns, 3)),
        "count": torch.randint(cfg.n_image[0], cfg.n_image[1] + 1,
                               (batch, 1, 1), generator=gen,
                               device=gen.device),
        "u": _uniform(gen, (batch, ns, n_img)),
        "pert": _uniform(gen, (batch, ns, n_img), cfg.a, cfg.b),
    }


def _segment_sum(flat_idx, values, size):
    """A [size] tensor with values summed at flat_idx, in a fixed order: a
    stable sort by position, a running sum in f64, and each position's run
    as the difference of the sums at its ends."""
    order = torch.sort(flat_idx, stable=True)
    idx = order.values
    total = values[order.indices].double().cumsum(0)
    last = torch.ones_like(idx, dtype=torch.bool)
    last[:-1] = idx[1:] != idx[:-1]
    ends = total[last]
    sums = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
    out = torch.zeros(size, dtype=values.dtype, device=values.device)
    out[idx[last]] = sums.to(values.dtype)
    return out


def _cudnn_exact():
    """cuDNN with deterministic algorithms and TF32 off, for this call."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=False, deterministic=True, allow_tf32=False)


def image_taps(draws: dict, cfg: RirConfig):
    """The taps of the draws' rooms: (delay [B, ns, 1 + n_img] in samples
    at the oversampled rate, decay [B, ns, 1 + n_img], 0 for images past
    the drawn count; the direct path first, direct_dist [B, ns])."""
    room, rt60 = draws["room"], draws["rt60"]
    batch, ns, n_img = draws["u"].shape
    device = room.device
    os_rate = cfg.sr * cfg.oversample
    wall = cfg.min_dis_wall

    mic_pos = draws["mic_pos"] * (room - 2 * wall) + wall
    # sources uniform in the room's interior, then radially clamped to
    # [mic_dist_lo, mic_dist_hi] of the microphone
    src = draws["src"] * (room[:, None] - 2 * wall) + wall
    delta = src - mic_pos[:, None]
    dist = torch.sqrt(torch.sum(delta ** 2, -1, keepdim=True) + 1e-6)
    clamped = torch.clamp(dist, cfg.mic_dist[0], cfg.mic_dist[1])
    src = mic_pos[:, None] + delta / dist * clamped
    src = torch.minimum(torch.maximum(src, torch.full_like(src, wall)),
                        room[:, None] - wall)
    direct_dist = torch.sqrt(
        torch.sum((src - mic_pos[:, None]) ** 2, -1) + 1e-3)  # [B, ns]

    r = 1.0 / (2.0 * (1.0 / room[:, 0] + 1.0 / room[:, 1]
                      + 1.0 / room[:, 2]))
    reflect_coef = torch.sqrt(
        1.0 - (1.0 - torch.exp(-0.16 * r[:, None, None] / rt60)) ** 2)
    valid = torch.arange(n_img, device=device)[None, None, :] \
        < draws["count"]  # [B, 1, n_img]

    # distance ratios from the linear pdf by its inverse CDF
    u = torch.sqrt(draws["u"])
    max_ratio = _VELOCITY * rt60 / direct_dist[..., None] - 1.0
    dist_nearest_ratio = 1.0 + u * torch.clamp(max_ratio - 1.0, min=0.0)
    img_dist_vec = direct_dist[..., None] * dist_nearest_ratio
    dist_img = torch.sqrt(img_dist_vec ** 2 + 1e-3)

    reflect_max = (torch.log10(_VELOCITY * rt60) - 3.0) \
        / torch.log10(reflect_coef)
    reflect_ratio = (dist_img / (_VELOCITY * rt60)) * (reflect_max - 1.0) \
        + 1.0
    pert = draws["pert"] * dist_nearest_ratio ** cfg.tau
    reflect_ratio = torch.clamp(reflect_ratio + pert, min=1.0)

    # the direct path first
    dist_all = torch.cat([direct_dist[..., None], dist_img], -1)
    reflect_all = torch.cat(
        [torch.zeros(batch, ns, 1, device=device), reflect_ratio], -1)
    valid_all = torch.cat(
        [torch.ones(batch, ns, 1, dtype=torch.bool, device=device),
         valid.expand(batch, ns, n_img)], -1)
    decay = reflect_coef ** reflect_all / dist_all
    decay = torch.where(valid_all, decay, torch.zeros_like(decay))
    return dist_all * (os_rate / _VELOCITY), decay, direct_dist


def sample_rirs(draws: dict, cfg: RirConfig):
    """-> (rir [B, ns, L], early [B, ns, L]) at cfg.sr, float32, from the
    draws of `draw_rirs` (single microphone). L = ceil(sr * rt60_max)."""
    rt60 = draws["rt60"]
    batch, ns, _ = draws["u"].shape
    device = rt60.device
    os_rate = cfg.sr * cfg.oversample
    hi_len = int(np.ceil(os_rate * cfg.rt60[1]))
    out_len = int(np.ceil(cfg.sr * cfg.rt60[1]))
    delay, decay, direct_dist = image_taps(draws, cfg)

    # fractional-delay scatter at the oversampled rate (linear interp);
    # taps past this sample's RIR length go to the trash slot hi_len
    idx0 = torch.floor(delay).to(torch.int64)
    frac = delay - idx0
    hi_len_b = torch.ceil(os_rate * rt60).to(torch.int64)  # [B, 1, 1]
    oob = idx0 >= torch.clamp(hi_len_b, max=hi_len - 1)
    idx0 = torch.where(oob, torch.full_like(idx0, hi_len), idx0)
    row = (torch.arange(batch, device=device)[:, None, None] * ns
           + torch.arange(ns, device=device)[None, :, None]) * (hi_len + 2)
    flat = torch.cat([(row + idx0).reshape(-1), (row + idx0 + 1).reshape(-1)])
    taps = torch.cat([(decay * (1.0 - frac)).reshape(-1),
                      (decay * frac).reshape(-1)])
    rir_hi = _segment_sum(flat, taps, batch * ns * (hi_len + 2)).view(
        batch, ns, hi_len + 2)[..., :hi_len]

    # the early part: [-6, +50] ms around the direct tap
    direct_idx = torch.ceil(direct_dist * (os_rate / _VELOCITY))[..., None]
    lo = torch.clamp(direct_idx + os_rate * (-6) // 1000, min=0)
    hi = direct_idx + os_rate * 50 // 1000
    pos = torch.arange(hi_len, device=device)[None, None, :]
    early_hi = rir_hi * ((pos >= lo) & (pos < hi)).to(torch.float32)

    fir = torch.from_numpy(_decim_fir(cfg.oversample, cfg.sr)).to(device)
    pad = fir.shape[0] // 2

    def decimate(x):
        with _cudnn_exact():
            y = F.conv1d(x.reshape(batch * ns, 1, -1), fir[None, None, :],
                         stride=cfg.oversample, padding=pad)
        return y.reshape(batch, ns, -1)[..., :out_len]

    return decimate(rir_hi), decimate(early_hi)


def fft_convolve(wav: torch.Tensor, rir: torch.Tensor) -> torch.Tensor:
    """Batched FFT convolution trimmed to the wav's length: wav [..., T],
    rir [..., L] -> [..., T] in the wav's dtype (a full convolution's first
    T samples; the FFT length is the next power of two of T + L - 1)."""
    t, length = wav.shape[-1], rir.shape[-1]
    n = int(2 ** np.ceil(np.log2(t + length - 1)))
    y = torch.fft.irfft(torch.fft.rfft(wav, n=n) * torch.fft.rfft(rir, n=n),
                        n=n)
    return y[..., :t].to(wav.dtype)


def reverberate(wavs, rirs, coin, prob: float = 1.0):
    """Each source [B, S, T] reverberated by its RIR [B, S, L] and brought
    to a peak of 0.9 where its coin [B, S, 1] (uniform) is below `prob`,
    else kept dry."""
    rev = fft_convolve(wavs, rirs)
    peak = torch.amax(torch.abs(rev), -1, keepdim=True)
    rev = rev / torch.clamp(peak, min=1e-10) * 0.9
    return torch.where(coin < prob, rev, wavs)


def snr_mix(srcs: torch.Tensor, snr: Optional[torch.Tensor]):
    """srcs [B, S, T] -> (mix [B, T], scaled sources [B, S, T]): each
    interferer scaled to the target's energy times 10^(snr / 20) (snr [B,
    S, 1], the target's ignored; None: 0 dB), the sum and the sources then
    divided by the largest absolute value among them."""
    target_e = torch.sum(srcs[:, :1] ** 2, -1, keepdim=True)
    if snr is None:
        snr = torch.zeros(srcs.shape[:2] + (1,), device=srcs.device)
    snr = torch.cat([torch.zeros_like(snr[:, :1]), snr[:, 1:]], 1)
    energy = torch.sum(srcs ** 2, -1, keepdim=True)
    scale = torch.sqrt(target_e / torch.clamp(energy, min=1e-10)) \
        * 10 ** (snr / 20.0)
    scale = torch.cat([torch.ones_like(scale[:, :1]), scale[:, 1:]], 1)
    scaled = srcs * scale
    mix = torch.sum(scaled, 1)
    max_amp = torch.maximum(
        torch.amax(torch.abs(mix), -1, keepdim=True),
        torch.amax(torch.abs(scaled), (1, 2))[:, None])
    norm = 1.0 / torch.clamp(max_amp, min=1e-10)
    return mix * norm, scaled * norm[:, None]


def add_noise_snr(mix, noise, snr, coin, prob: float = 1.0,
                  speech_noise: Optional[torch.Tensor] = None,
                  snr_speech: Optional[torch.Tensor] = None):
    """mix and noise [B, T]: the noise scaled to the mixture's power at
    -snr dB (snr [B, 1]) and added where the coin [B, 1] is below `prob`;
    where `speech_noise` [B] (bool) is set, at `snr_speech` instead."""
    if speech_noise is not None:
        snr = torch.where(speech_noise[:, None], snr_speech, snr)
    power = torch.mean(mix ** 2, -1, keepdim=True)
    n_power = torch.mean(noise ** 2, -1, keepdim=True)
    scale = 10 ** (-snr / 20.0) * torch.sqrt(power) \
        / torch.sqrt(torch.clamp(n_power, min=1e-10))
    return torch.where(coin < prob, mix + scale * noise, mix)


def draw_augment(gen: torch.Generator, batch: int, num_src: int,
                 cfg: Optional[RirConfig] = None, reverb_prob: float = 0.0,
                 use_random_snr: bool = True, noise_prob: float = 0.0,
                 noise_snr: Tuple[float, float] = (-5.0, 25.0)) -> dict:
    """The random tensors of `augment_batch` for `batch` mixtures of
    `num_src` sources, in this order: the RIR draws (`rir`, with reverb),
    the reverb coins `reverb_coin` [B, S, 1], the SNRs `snr` [B, S, 1] (with
    `use_random_snr`, uniform in [-10, 10) dB), and with noise its SNRs
    `noise_snr` [B, 1] in [noise_snr) and coins `noise_coin` [B, 1]."""
    draws = {}
    if reverb_prob > 0:
        cfg = cfg or RirConfig(num_src=num_src)
        draws["rir"] = draw_rirs(gen, batch, cfg)
        draws["reverb_coin"] = _uniform(gen, (batch, num_src, 1))
    if use_random_snr:
        draws["snr"] = _uniform(gen, (batch, num_src, 1), -10.0, 10.0)
    if noise_prob > 0:
        draws["noise_snr"] = _uniform(gen, (batch, 1), *noise_snr)
        draws["noise_coin"] = _uniform(gen, (batch, 1))
    return draws


def take_rows(draws: dict, start: int, rows: int) -> dict:
    """The draws of mixtures [start, start + rows) (every draw's leading
    axis is the mixture)."""
    return {k: take_rows(v, start, rows) if isinstance(v, dict)
            else v[start:start + rows] for k, v in draws.items()}


def augment_batch(srcs: torch.Tensor, draws: dict,
                  noise: Optional[torch.Tensor] = None,
                  cfg: Optional[RirConfig] = None, reverb_prob: float = 0.0,
                  noise_prob: float = 0.0):
    """The whole simulation on the sources' device: FRAM-RIR reverb per
    source (reverb_prob > 0) -> SNR mixing -> additive noise (with `noise`
    [B, T] and noise_prob > 0), from the draws of `draw_augment`.

    srcs: [B, S, T] dry sources -> (mix [B, T], targets [B, S, T]). As in
    the host chain, a reverberant source is both mixed and the target;
    noise goes into the mixture only."""
    mix_srcs = srcs
    if reverb_prob > 0:
        cfg = cfg or RirConfig(num_src=srcs.shape[1])
        rirs, _ = sample_rirs(draws["rir"], cfg)
        mix_srcs = reverberate(srcs, rirs, draws["reverb_coin"], reverb_prob)
    mix, scaled = snr_mix(mix_srcs, draws.get("snr"))
    if noise is not None and noise_prob > 0:
        mix = add_noise_snr(mix, noise, draws["noise_snr"],
                            draws["noise_coin"], noise_prob)
    return mix, scaled
