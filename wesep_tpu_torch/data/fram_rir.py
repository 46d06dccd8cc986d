"""FRAM-RIR: fast random approximation of room impulse responses
(arXiv:2304.08052), on the host in numpy and scipy.

Counterpart of wesep_tpu/data/fram_rir.py, for the host augmentation path
(processor.add_reverb, add_reverb_on_enroll). Instead of the image-source
method it draws `n_image` virtual sources at random distances and angles,
gives each a reflection count (with a perturbation), scatter-adds their
decayed impulses on a 64x-oversampled grid, then resamples 8x and 8x
(polyphase) around an 80 Hz highpass biquad. Every draw comes from the
`rng` argument, a numpy Generator; without one, from a fresh
`np.random.default_rng()` (unseeded), as the JAX package's does.

The batched variant on the device is wesep_tpu_torch.data.augment.
"""

import numpy as np
from scipy import signal as sp_signal

__all__ = ["FRAM_RIR", "single_channel", "multi_channel_array",
           "multi_channel_adhoc", "sample_a_config", "sample_src_pos",
           "sample_mic_arch", "sample_mic_array_pos"]


def _highpass_biquad(x: np.ndarray, sr: float, cutoff: float = 80.0,
                     q: float = 0.707) -> np.ndarray:
    """RBJ audio-EQ-cookbook highpass biquad (torchaudio.functional
    highpass_biquad equivalent)."""
    w0 = 2.0 * np.pi * cutoff / sr
    alpha = np.sin(w0) / (2.0 * q)
    cosw = np.cos(w0)
    b0 = (1 + cosw) / 2
    b1 = -(1 + cosw)
    b2 = (1 + cosw) / 2
    a0 = 1 + alpha
    a1 = -2 * cosw
    a2 = 1 - alpha
    b = np.array([b0, b1, b2]) / a0
    a = np.array([1.0, a1 / a0, a2 / a0])
    return sp_signal.lfilter(b, a, x, axis=-1)


def _resample(x: np.ndarray, orig: int, new: int) -> np.ndarray:
    g = np.gcd(int(orig), int(new))
    return sp_signal.resample_poly(x, new // g, orig // g, axis=-1)


def FRAM_RIR(
    mic_pos,
    sr,
    T60,
    room_dim,
    src_pos,
    num_src=1,
    direct_range=(-6, 50),
    n_image=(1024, 4097),
    a=-2.0,
    b=2.0,
    tau=0.25,
    rng: np.random.Generator | None = None,
):
    """-> (rir [n_mic, n_src, L], early_rir [n_mic, n_src, L]) at rate sr."""
    rng = rng or np.random.default_rng()
    image = int(rng.integers(n_image[0], n_image[1]))

    room_dim = np.asarray(room_dim, np.float64)
    R = 1.0 / (2 * (1.0 / room_dim[0] + 1.0 / room_dim[1] + 1.0 / room_dim[2]))

    mic_position = np.asarray(mic_pos, np.float64)  # [n_mic, 3]
    src_position = np.asarray(src_pos, np.float64)  # [n_src, 3]
    n_mic = mic_position.shape[0]
    num_src = src_position.shape[0]

    # [n_mic, n_src]
    direct_dist = np.sqrt(
        ((mic_position[:, None] - src_position[None]) ** 2).sum(-1) + 1e-3
    )
    nearest_mic_idx = direct_dist.argmin(0)  # [n_src]
    nearest_dist = direct_dist.min(0)
    nearest_mic_position = mic_position[nearest_mic_idx]  # [n_src, 3]

    ns = n_mic * num_src
    ratio = 64
    sample_sr = sr * ratio
    velocity = 340.0

    direct_idx = np.ceil(direct_dist * sample_sr / velocity).astype(
        np.int64
    ).reshape(ns)
    rir_length = int(np.ceil(sample_sr * T60))

    reflect_coef = np.sqrt(1 - (1 - np.exp(-0.16 * R / T60)) ** 2)

    # distance ratios: linspace grid per source, sampled by a linear pdf
    dist_prob = np.linspace(0.0, 1.0, rir_length)
    dist_prob /= dist_prob.sum()
    dist_select_idx = rng.choice(
        rir_length, size=(num_src, image), replace=True, p=dist_prob
    )
    dist_nearest_ratio = np.stack(
        [
            np.linspace(
                1.0, velocity * T60 / nearest_dist[i] - 1, rir_length
            )[dist_select_idx[i]]
            for i in range(num_src)
        ],
        0,
    )  # [n_src, image]

    azm = rng.uniform(-np.pi, np.pi, size=(num_src, image))
    ele = rng.uniform(-np.pi / 2, np.pi / 2, size=(num_src, image))
    unit_3d = np.stack(
        [np.sin(ele) * np.cos(azm), np.sin(ele) * np.sin(azm), np.cos(ele)],
        -1,
    )  # [n_src, image, 3]
    image2nearest = nearest_dist[:, None, None] * dist_nearest_ratio[..., None]
    image_position = nearest_mic_position[:, None] + image2nearest * unit_3d

    # [n_mic, n_src, image]
    dist = np.sqrt(
        ((mic_position[:, None, None] - image_position[None]) ** 2).sum(-1)
        + 1e-3
    )

    reflect_max = (np.log10(velocity * T60) - 3) / np.log10(reflect_coef)
    reflect_ratio = (dist / (velocity * T60)) * (reflect_max - 1) + 1
    reflect_pertub = rng.uniform(a, b, size=(num_src, image)) * (
        dist_nearest_ratio**tau
    )
    reflect_ratio = np.maximum(reflect_ratio + reflect_pertub[None], 1.0)

    # prepend the direct path
    dist = np.concatenate([direct_dist[..., None], dist], 2)
    reflect_ratio = np.concatenate(
        [np.zeros((n_mic, num_src, 1)), reflect_ratio], 2
    )

    delta_idx = np.minimum(
        np.ceil(dist * sample_sr / velocity), rir_length - 1
    ).astype(np.int64).reshape(ns, -1)
    delta_decay = (reflect_coef**reflect_ratio / dist).reshape(ns, -1)

    rir = np.zeros((ns, rir_length))
    for i in range(ns):
        np.add.at(rir[i], delta_idx[i], delta_decay[i])

    direct_mask = np.zeros((ns, rir_length))
    for i in range(ns):
        lo = max(int(direct_idx[i]) + sample_sr * direct_range[0] // 1000, 0)
        hi = min(
            int(direct_idx[i]) + sample_sr * direct_range[1] // 1000,
            rir_length,
        )
        direct_mask[i, lo:hi] = 1.0
    rir_direct = rir * direct_mask

    all_rir = np.stack([rir, rir_direct], 1).reshape(ns * 2, -1)
    mid_sr = sample_sr // int(np.sqrt(ratio))
    rir_ds = _resample(all_rir, sample_sr, mid_sr)
    rir_hp = _highpass_biquad(rir_ds, mid_sr, 80.0)
    out = _resample(rir_hp, mid_sr, sr).astype(np.float32)
    out = out.reshape(n_mic, num_src, 2, -1)
    return out[:, :, 0], out[:, :, 1]


def sample_src_pos(room_dim, num_src, array_pos, min_mic_dis=0.5,
                   max_mic_dis=5, min_dis_wall=None,
                   rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    if min_dis_wall is None:
        min_dis_wall = [0.5, 0.5, 0.5]
    src_pos = []
    while len(src_pos) < num_src:
        pos = rng.uniform(
            np.array(min_dis_wall), np.array(room_dim) - np.array(min_dis_wall)
        )
        dis = np.linalg.norm(pos - np.array(array_pos))
        if min_mic_dis <= dis <= max_mic_dis:
            src_pos.append(pos)
    return np.stack(src_pos, 0)


def sample_mic_arch(n_mic, mic_spacing=None, bounding_box=None,
                    rng: np.random.Generator | None = None):
    """Sample an ad-hoc mic geometry: `k ~ U{n_mic[0]..n_mic[1]}` points
    inside `bounding_box` with every pairwise distance in `mic_spacing`
    (rejection sampling). Returns relative coordinates [k, 3] in metres."""
    rng = rng or np.random.default_rng()
    if mic_spacing is None:
        mic_spacing = [0.02, 0.10]
    if bounding_box is None:
        bounding_box = [0.08, 0.12, 0]
    k = int(rng.integers(n_mic[0], n_mic[1] + 1))
    if k == 1:
        return np.array([[0.0, 0.0, 0.0]])
    pts = []
    while len(pts) < k:
        cand = rng.uniform(np.zeros(3), np.array(bounding_box))
        if all(
            mic_spacing[0] <= np.linalg.norm(cand - o) <= mic_spacing[1]
            for o in pts
        ):
            pts.append(cand)
    return np.stack(pts, 0)


def sample_mic_array_pos(mic_arch, room_dim, min_dis_wall=None,
                         rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    if min_dis_wall is None:
        min_dis_wall = [0.5, 0.5, 0.5]
    if isinstance(mic_arch, dict):  # adhoc array
        n_mic = mic_arch["n_mic"]
        spacing, bounding_box = mic_arch["spacing"], mic_arch["bounding_box"]
        sample_n_mic = int(rng.integers(n_mic[0], n_mic[1] + 1))
        if sample_n_mic == 1:
            mic_arch = np.array([[0.0, 0.0, 0.0]])
        else:
            pts = [rng.uniform(np.zeros(3), np.array(bounding_box))]
            while len(pts) < sample_n_mic:
                cand = rng.uniform(np.zeros(3), np.array(bounding_box))
                if all(
                    spacing[0] <= np.linalg.norm(cand - o) <= spacing[1]
                    for o in pts
                ):
                    pts.append(cand)
            mic_arch = np.stack(pts, 0)
    else:
        mic_arch = np.asarray(mic_arch, np.float64)

    center = mic_arch.mean(0, keepdims=True)
    max_radius = np.max(np.linalg.norm(mic_arch - center, axis=-1))
    array_pos = rng.uniform(
        np.array(min_dis_wall) + max_radius,
        np.array(room_dim) - np.array(min_dis_wall) - max_radius,
    ).reshape(1, 3)
    rot = rng.uniform(-np.pi, np.pi)
    rx = mic_arch[:, 0] * np.cos(rot) + mic_arch[:, 1] * np.sin(rot)
    ry = mic_arch[:, 1] * np.cos(rot) - mic_arch[:, 0] * np.sin(rot)
    mic_pos = array_pos + np.stack([rx, ry, np.zeros_like(rx)], -1)
    return mic_pos, array_pos


def sample_a_config(simu_config, rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    room_config = simu_config["min_max_room"]
    room_dim = rng.uniform(np.array(room_config[0]), np.array(room_config[1]))
    rt60 = rng.uniform(*simu_config["rt60"])
    sr = simu_config["sr"]
    if "array_pos" not in simu_config:
        mic_pos, array_pos = sample_mic_array_pos(
            simu_config["mic_arch"], room_dim, rng=rng
        )
    else:
        array_pos = simu_config["array_pos"]
        mic_pos = np.asarray(array_pos).reshape(1, 3)
    if "src_pos" not in simu_config:
        src_pos = sample_src_pos(
            room_dim,
            simu_config["num_src"],
            array_pos,
            min_mic_dis=simu_config["mic_dist"][0],
            max_mic_dis=simu_config["mic_dist"][1],
            rng=rng,
        )
    else:
        src_pos = np.asarray(simu_config["src_pos"])
    return mic_pos, sr, rt60, room_dim, src_pos, array_pos


def single_channel(simu_config, rng: np.random.Generator | None = None):
    """One microphone: -> (rir [1, n_src, L], early [1, n_src, L])."""
    cfg = dict(simu_config)
    cfg["mic_arch"] = {"n_mic": [1, 1], "spacing": None, "bounding_box": None}
    mic_pos, sr, rt60, room_dim, src_pos, _ = sample_a_config(cfg, rng)
    return FRAM_RIR(mic_pos, sr, rt60, room_dim, src_pos, rng=rng)


def multi_channel_array(simu_config, rng: np.random.Generator | None = None):
    """Fixed 2-mic linear array (10 cm aperture), randomly placed and
    rotated in the room. -> (rir [2, n_src, L], early [2, n_src, L])."""
    cfg = dict(simu_config)
    cfg.pop("array_pos", None)  # geometry is prescribed; placement sampled
    cfg["mic_arch"] = [[-0.05, 0, 0], [0.05, 0, 0]]
    mic_pos, sr, rt60, room_dim, src_pos, _ = sample_a_config(cfg, rng)
    return FRAM_RIR(mic_pos, sr, rt60, room_dim, src_pos, rng=rng)


def multi_channel_adhoc(simu_config, rng: np.random.Generator | None = None):
    """Ad-hoc array: 1-3 mics scattered in a 0.5 x 1.0 m region with
    2-5 cm pairwise spacing. -> (rir [k, n_src, L], early [k, n_src, L])."""
    cfg = dict(simu_config)
    cfg.pop("array_pos", None)
    cfg["mic_arch"] = {
        "n_mic": [1, 3],
        "spacing": [0.02, 0.05],
        "bounding_box": [0.5, 1.0, 0],
    }
    mic_pos, sr, rt60, room_dim, src_pos, _ = sample_a_config(cfg, rng)
    return FRAM_RIR(mic_pos, sr, rt60, room_dim, src_pos, rng=rng)
