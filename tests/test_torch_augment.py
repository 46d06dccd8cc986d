"""Port parity: the simulation on the device (data/augment.py), the noise
store and the host FRAM-RIR against the JAX package, on the CPU in f32.

A torch generator cannot draw what `jax.random` draws, so the draws are
replicated here with `jax.random` calls in `wesep_tpu.data.augment`'s
order and fed to the port's deterministic parts. Limits: RIRs rel. L2 1e-4
(image delays of up to 89 600 oversampled samples round to one or two f32
units apart, which moves a tap by up to 0.012 samples and, rarely, by one
sample through `floor`); the FFT convolution, reverb, mixing, noise and the
whole batch 1e-5 of their largest value.
"""

import functools
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wesep_tpu.data import augment as jax_augment
from wesep_tpu.data import fram_rir as jax_fram_rir
from wesep_tpu.data import noise_store as jax_noise_store
from wesep_tpu_torch.data import augment, fram_rir, noise_store
from wesep_tpu_torch.data.wav_io import write_wav

torch.set_num_threads(1)  # one intra-op thread per test worker

SMALL = dict(sr=2000, n_image=(16, 64), rt60=(0.1, 0.3))


def _tensor(x, dtype=None):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(dtype or x.dtype))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _rir_draws(key, batch, cfg):
    keys = jax.random.split(key, 12)
    ns, n_img = cfg.num_src, cfg.n_image[1]
    u = jax.random.uniform
    return {
        "room": u(keys[0], (batch, 3), minval=jnp.asarray(cfg.room_lo),
                  maxval=jnp.asarray(cfg.room_hi)),
        "rt60": u(keys[1], (batch, 1, 1), minval=cfg.rt60[0],
                  maxval=cfg.rt60[1]),
        "mic_pos": u(keys[2], (batch, 3)),
        "src": u(keys[3], (batch, ns, 3)),
        "count": jax.random.randint(keys[4], (batch, 1, 1), cfg.n_image[0],
                                    cfg.n_image[1] + 1),
        "u": u(keys[5], (batch, ns, n_img)),
        "pert": u(keys[8], (batch, ns, n_img), minval=cfg.a, maxval=cfg.b),
    }


def _torch_draws(draws):
    return {k: _torch_draws(v) if isinstance(v, dict) else _tensor(
        v, np.int64 if k == "count" else np.float32)
        for k, v in draws.items()}


def jax_rir_draws(key, batch, cfg):
    """The draws of wesep_tpu.data.augment.sample_rirs for `key`, by the
    port's names (its keys 6 and 7, the unused angles, are not drawn)."""
    return _torch_draws(_rir_draws(key, batch, cfg))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def _augment_draws(key, batch, num_src, cfg, reverb_prob, use_random_snr,
                   noise_prob, noise_snr):
    k_rir, k_rev, k_mix, k_noise = jax.random.split(key, 4)
    draws = {}
    if reverb_prob > 0:
        draws["rir"] = _rir_draws(k_rir, batch, cfg)
        draws["reverb_coin"] = jax.random.uniform(k_rev, (batch, num_src, 1))
    if use_random_snr:
        draws["snr"] = jax.random.uniform(
            k_mix, (batch, num_src, 1), minval=-10.0, maxval=10.0)
    if noise_prob > 0:
        k1, k2 = jax.random.split(k_noise)
        draws["noise_snr"] = jax.random.uniform(
            k1, (batch, 1), minval=noise_snr[0], maxval=noise_snr[1])
        draws["noise_coin"] = jax.random.uniform(k2, (batch, 1))
    return draws


def jax_augment_draws(key, batch, num_src, cfg, reverb_prob, use_random_snr,
                      noise_prob, noise_snr=(-5.0, 25.0)):
    """The draws of wesep_tpu.data.augment.augment_batch for `key`, in the
    form of the port's `draw_augment`."""
    return _torch_draws(_augment_draws(
        key, batch, num_src, cfg, reverb_prob, use_random_snr, noise_prob,
        tuple(noise_snr)))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, limit=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= limit * np.abs(want).max(), err


def _jax_delays(draws, cfg):
    """The image delays of wesep_tpu.data.augment.sample_rirs (its lines
    up to `delay`, in jnp on the same draws)."""
    d = {k: jnp.asarray(v.numpy()) for k, v in draws.items()}
    room, rt60, wall = d["room"], d["rt60"], cfg.min_dis_wall
    mic = d["mic_pos"] * (room - 2 * wall) + wall
    src = d["src"] * (room[:, None] - 2 * wall) + wall
    delta = src - mic[:, None]
    dist = jnp.sqrt(jnp.sum(delta ** 2, -1, keepdims=True) + 1e-6)
    src = mic[:, None] + delta / dist * jnp.clip(dist, *cfg.mic_dist)
    src = jnp.clip(src, wall, room[:, None] - wall)
    direct = jnp.sqrt(jnp.sum((src - mic[:, None]) ** 2, -1) + 1e-3)
    ratio = 1.0 + jnp.sqrt(d["u"]) * jnp.maximum(
        340.0 * rt60 / direct[..., None] - 2.0, 0.0)
    img = jnp.sqrt((direct[..., None] * ratio) ** 2 + 1e-3)
    dist_all = jnp.concatenate([direct[..., None], img], -1)
    return np.asarray(dist_all * (cfg.sr * cfg.oversample / 340.0))


@pytest.mark.parametrize("kw,batch", [(SMALL, 3), ({}, 1)],
                         ids=["small", "default"])
def test_sample_rirs_match_jax(kw, batch, capsys):
    """RIRs and their early part from the same draws: rel. L2 1e-4; the
    taps whose integer delay differs from the JAX package's are counted
    and are few."""
    jcfg, cfg = jax_augment.RirConfig(**kw), augment.RirConfig(**kw)
    key = jax.random.PRNGKey(3)
    want_rir, want_early = jax.jit(
        lambda k: jax_augment.sample_rirs(k, batch, jcfg))(key)
    draws = jax_rir_draws(key, batch, jcfg)
    rir, early = augment.sample_rirs(draws, cfg)
    assert rir.dtype == torch.float32
    assert rir.shape == (batch, 2, int(np.ceil(cfg.sr * cfg.rt60[1])))
    assert _rel_l2(rir.numpy(), np.asarray(want_rir)) <= 1e-4
    assert _rel_l2(early.numpy(), np.asarray(want_early)) <= 1e-4
    delay = augment.image_taps(draws, cfg)[0].numpy()
    moved = int((np.floor(delay) != np.floor(_jax_delays(draws, jcfg))).sum())
    with capsys.disabled():
        print(f"\nsample_rirs {kw or 'default'}: rel. L2 "
              f"{_rel_l2(rir.numpy(), np.asarray(want_rir)):.2e}, taps "
              f"moved {moved} of {delay.size}")
    assert moved <= 1e-3 * delay.size


def test_fft_convolve_reverberate_snr_mix_and_noise_match_jax():
    rng = np.random.default_rng(0)
    wavs = rng.standard_normal((2, 2, 3000)).astype(np.float32) * 0.1
    rirs = rng.standard_normal((2, 2, 700)).astype(np.float32) \
        * np.exp(-np.arange(700) / 100.0).astype(np.float32)
    noise = rng.standard_normal((2, 3000)).astype(np.float32) * 0.01
    jw, jr = jnp.asarray(wavs), jnp.asarray(rirs)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    mixes = wavs.sum(1)

    @jax.jit
    def reference(key, k1, k2):
        """The JAX functions and the draws they take from their keys."""
        return {
            "conv": jax_augment.fft_convolve(jw, jr),
            "coin": jax.random.uniform(key, (2, 2, 1)),
            "reverb": jax_augment.reverberate(key, jw, jr, 0.5),
            "snr": jax.random.uniform(key, (2, 2, 1), minval=-10.0,
                                      maxval=10.0),
            "mix": jax_augment.snr_mix(key, jw, True),
            "mix_0db": jax_augment.snr_mix(key, jw, False),
            # both SNRs come from the same key k1, as in the JAX package
            "noise_snr": jax.random.uniform(k1, (2, 1), minval=-5.0,
                                            maxval=25.0),
            "speech_snr": jax.random.uniform(k1, (2, 1), minval=10.0,
                                             maxval=30.0),
            "noise_coin": jax.random.uniform(k2, (2, 1)),
            "noisy": jax_augment.add_noise_snr(
                key, jnp.asarray(mixes), jnp.asarray(noise), prob=0.7,
                speech_noise=jnp.asarray([True, False])),
        }

    want = reference(key, k1, k2)
    got = augment.fft_convolve(torch.from_numpy(wavs), torch.from_numpy(rirs))
    assert got.dtype == torch.float32
    _close(got, want["conv"])
    _close(augment.reverberate(torch.from_numpy(wavs), torch.from_numpy(rirs),
                               _tensor(want["coin"]), 0.5), want["reverb"])
    for snr, name in ((_tensor(want["snr"]), "mix"), (None, "mix_0db")):
        mix, scaled = augment.snr_mix(torch.from_numpy(wavs), snr)
        _close(mix, want[name][0])
        _close(scaled, want[name][1])
    got = augment.add_noise_snr(
        torch.from_numpy(mixes), torch.from_numpy(noise),
        _tensor(want["noise_snr"]), _tensor(want["noise_coin"]), 0.7,
        speech_noise=torch.tensor([True, False]),
        snr_speech=_tensor(want["speech_snr"]))
    _close(got, want["noisy"])


@pytest.mark.parametrize("reverb,random_snr,noise", [
    (1.0, True, 1.0), (0.5, False, 0.5), (0.0, True, 0.0)],
    ids=["all", "coins", "mix_only"])
def test_augment_batch_matches_jax(reverb, random_snr, noise):
    """The whole simulation of 3 mixtures x 2 sources x 3000 samples at a
    small RirConfig: mixture and targets 1e-5 of their largest value."""
    rng = np.random.default_rng(1)
    srcs = rng.standard_normal((3, 2, 3000)).astype(np.float32) * 0.1
    noise_wav = rng.standard_normal((3, 3000)).astype(np.float32) * 0.05
    jcfg, cfg = jax_augment.RirConfig(**SMALL), augment.RirConfig(**SMALL)
    key = jax.random.PRNGKey(11)
    want_mix, want_tgt = jax.jit(lambda k: jax_augment.augment_batch(
        k, jnp.asarray(srcs), jnp.asarray(noise_wav), jcfg, reverb,
        random_snr, noise, (-5.0, 25.0)))(key)
    draws = jax_augment_draws(key, 3, 2, jcfg, reverb, random_snr, noise)
    mix, tgt = augment.augment_batch(torch.from_numpy(srcs), draws,
                                     torch.from_numpy(noise_wav), cfg,
                                     reverb, noise)
    _close(mix, want_mix)
    _close(tgt, want_tgt)


def test_draws_repeat_for_a_seed_and_differ_for_another():
    cfg = augment.RirConfig(**SMALL)

    def draws(seed, step=3, micro=0):
        gen = augment.step_generator(seed, step, micro, "cpu")
        return augment.draw_augment(gen, 4, 2, cfg, 0.5, True, 0.5)

    def flat(d):
        return torch.cat([flat(v) if isinstance(v, dict)
                          else v.float().reshape(-1) for v in d.values()])

    a, b = draws(42), draws(42)
    assert torch.equal(flat(a), flat(b))
    for other in (draws(7), draws(42, step=4), draws(42, micro=1)):
        assert not torch.equal(flat(a), flat(other))
    rows = augment.take_rows(a, 1, 2)
    assert torch.equal(rows["rir"]["u"], a["rir"]["u"][1:3])
    assert torch.equal(rows["snr"], a["snr"][1:3])
    assert a["snr"].min() >= -10 and a["snr"].max() < 10
    assert ((a["noise_snr"] >= -5) & (a["noise_snr"] < 25)).all()
    count = a["rir"]["count"]
    assert ((count >= 16) & (count <= 64)).all()
    srcs = torch.randn(4, 2, 3000, generator=torch.Generator().manual_seed(0))
    mix, tgt = augment.augment_batch(srcs, a, torch.zeros(4, 3000), cfg, 0.5,
                                     0.5)
    again = augment.augment_batch(srcs, b, torch.zeros(4, 3000), cfg, 0.5,
                                  0.5)
    assert torch.equal(mix, again[0]) and torch.equal(tgt, again[1])
    assert mix.shape == (4, 3000) and tgt.shape == (4, 2, 3000)


@pytest.fixture(scope="module")
def noise_wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(2)
    paths = []
    for i, kind in enumerate(("noise", "music", "speech")):
        path = str(root / f"{kind}_{i}.wav")
        write_wav(path, rng.standard_normal(1000 + 100 * i).astype(
            np.float32) * 0.1, 8000 if kind == "music" else 16000)
        paths.append(path)
    return root, paths


def test_noise_pack_is_the_jax_packs(noise_wavs):
    """build_pack's file byte for byte, both readers' bytes, and the key
    random_one draws under one `random` seed."""
    root, paths = noise_wavs
    ours = noise_store.build_pack(paths, str(root / "port.pack"))
    theirs = jax_noise_store.build_pack(paths, str(root / "jax.pack"))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    keyed = noise_store.build_pack(paths, str(root / "keyed.pack"),
                                   ["a", "b", "c"])
    store, jstore = noise_store.NoiseStore(keyed), \
        jax_noise_store.NoiseStore(keyed)
    assert store.keys == jstore.keys == ["a", "b", "c"]
    for key, path in zip(store.keys, paths):
        with open(path, "rb") as f:
            assert store.get(key) == jstore.get(key) == f.read()
    random.seed(9)
    got = [store.random_one() for _ in range(6)]
    random.seed(9)
    assert got == [jstore.random_one() for _ in range(6)]
    with open(str(root / "bad.pack"), "wb") as f:
        f.write(b"NOTAPACK" + bytes(8))
    with pytest.raises(ValueError, match="noise pack"):
        noise_store.NoiseStore(str(root / "bad.pack"))
    os.makedirs(root / "lmdb_dir", exist_ok=True)
    with pytest.raises(ImportError, match="make_noise_db"):
        noise_store.NoiseStore(str(root / "lmdb_dir"))


@pytest.mark.parametrize("fn", ["single_channel", "multi_channel_array",
                                "multi_channel_adhoc"])
def test_fram_rir_is_the_jax_one_bit_for_bit(fn):
    """The host FRAM-RIR with the same numpy Generator: equal arrays."""
    cfg = {"min_max_room": [[3, 3, 2.5], [10, 6, 4]], "rt60": [0.1, 0.3],
           "sr": 8000, "mic_dist": [0.2, 5.0], "num_src": 2}
    got = getattr(fram_rir, fn)(cfg, np.random.default_rng(4))
    want = getattr(jax_fram_rir, fn)(cfg, np.random.default_rng(4))
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_wav_bytes_of_the_store_decode(noise_wavs):
    """A pack's entry decodes to the wav it was built from."""
    root, paths = noise_wavs
    from wesep_tpu_torch.data.wav_io import read_wav

    store = noise_store.NoiseStore(noise_store.build_pack(
        paths, str(root / "decode.pack")))
    wav, sr = read_wav(store.get("music_1"))
    want, want_sr = read_wav(paths[1])
    assert sr == want_sr == 8000 and np.array_equal(wav, want)
