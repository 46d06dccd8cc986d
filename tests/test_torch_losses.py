"""Port parity: every loss of the table and both schedulers against the JAX
package, on the same numpy-seeded arrays."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from wesep_tpu.train import losses as jax_losses
from wesep_tpu.train import schedulers as jax_sched
from wesep_tpu_torch.ops.stft import hann_window, stft
from wesep_tpu_torch.train import losses, schedulers

torch.set_num_threads(1)  # one intra-op thread per test worker


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal(shape).astype(np.float32) * 0.3
    est = ref + rng.standard_normal(shape).astype(np.float32) * 0.1
    return est, ref


# f32 on both sides; the spectral losses sum thousands of bins in another
# order and take logs of small magnitudes, so they get 1e-4, the rest 1e-5
@pytest.mark.parametrize("name,shape,tol", [
    ("L1", (3, 4000), 1e-5), ("L2", (3, 4000), 1e-5),
    ("SISDR", (3, 4000), 1e-5), ("SISNR", (3, 4000), 1e-5),
    ("SNR", (3, 4000), 1e-5), ("STFT", (2, 6000), 1e-4),
    ("MultiResolutionSTFT", (2, 6000), 1e-4), ("PIT", (3, 2, 3000), 1e-5),
])
def test_loss_matches_jax(name, shape, tol):
    est, ref = _pair(shape, seed=len(name))
    want = np.asarray(jax_losses.get_loss(name)(jnp.asarray(est),
                                                jnp.asarray(ref)))
    got = losses.get_loss(name)(torch.from_numpy(est), torch.from_numpy(ref))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_ce_matches_jax_and_is_routed():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    want = np.asarray(jax_losses.ce_loss(jnp.asarray(logits),
                                         jnp.asarray(labels)))
    got = losses.ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert losses.is_ce(losses.get_loss("CE"))
    assert not losses.is_ce(losses.get_loss("SISDR"))


def test_parse_loss_and_unknown_name():
    fns = losses.parse_loss(["SISDR", "CE"])
    assert fns == [losses.si_sdr_loss, losses.ce_loss]
    assert losses.parse_loss("L1") == [losses.l1_loss]
    with pytest.raises(ValueError):
        losses.get_loss("nope")


def test_losses_take_bf16_and_compute_in_f32():
    est, ref = _pair((2, 3000), seed=5)
    e16 = torch.from_numpy(est).bfloat16()
    got = losses.si_sdr_loss(e16, torch.from_numpy(ref))
    want = losses.si_sdr_loss(e16.float(), torch.from_numpy(ref))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want)


def test_si_sdr_gradient_matches_jax():
    """The loss feeds the backward pass: d mean(loss) / d est, rtol 1e-4."""
    import jax

    est, ref = _pair((2, 2000), seed=6)
    want = np.asarray(jax.grad(
        lambda e: jnp.mean(jax_losses.si_sdr_loss(e, jnp.asarray(ref))))(
            jnp.asarray(est)))
    e = torch.from_numpy(est).requires_grad_()
    losses.si_sdr_loss(e, torch.from_numpy(ref)).mean().backward()
    np.testing.assert_allclose(e.grad.numpy(), want, rtol=1e-4, atol=1e-7)


def test_stft_pads_a_short_window_centred():
    """A window shorter than n_fft is centre-padded, as the spectral losses
    need; the result equals passing the padded window."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    short = hann_window(240)
    padded = torch.nn.functional.pad(short, (136, 136))
    a = stft(x, 512, 50, window=short)
    b = stft(x, 512, 50, window=padded)
    torch.testing.assert_close(a[0], b[0])
    torch.testing.assert_close(a[1], b[1])


STEPS = [0, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 119]  # a dozen, across cycles


@pytest.mark.parametrize("name,kwargs", [
    ("ExponentialDecrease", dict(num_epochs=12, epoch_iter=10,
                                 initial_lr=1e-3, final_lr=2.5e-5,
                                 warm_up_epoch=0, warm_from_zero=False)),
    ("ExponentialDecrease", dict(num_epochs=12, epoch_iter=10,
                                 initial_lr=1e-3, final_lr=2.5e-5,
                                 warm_up_epoch=2, scale_ratio=4.0,
                                 warm_from_zero=True)),
    ("ExponentialDecrease", dict(num_epochs=12, epoch_iter=10,
                                 initial_lr=1e-3, final_lr=2.5e-5,
                                 warm_up_epoch=3, scale_ratio=2.0)),
    ("TriAngular2", dict(num_epochs=12, epoch_iter=10, initial_lr=1e-3,
                         final_lr=1e-5, warm_up_epoch=1, scale_ratio=2.0,
                         cycle_step=2)),
])
def test_scheduler_matches_jax(name, kwargs):
    """The JAX schedules compute in f32, the port's in Python floats:
    rtol 1e-5."""
    want_fn = jax_sched.get_scheduler(name, **kwargs)
    got_fn = schedulers.get_scheduler(name, **kwargs)
    want = [float(want_fn(jnp.asarray(s))) for s in STEPS]
    got = [got_fn(s) for s in STEPS]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("increase_type", ["exp", "linear"])
def test_margin_scheduler_matches_jax(increase_type):
    kwargs = dict(initial_margin=0.0, final_margin=0.2,
                  increase_start_epoch=2, fix_start_epoch=6, epoch_iter=10,
                  increase_type=increase_type)
    want_fn = jax_sched.margin_scheduler(**kwargs)
    got_fn = schedulers.margin_scheduler(**kwargs)
    want = [float(want_fn(s)) for s in STEPS]
    np.testing.assert_allclose([got_fn(s) for s in STEPS], want,
                               rtol=1e-5, atol=1e-8)


def test_unknown_scheduler():
    with pytest.raises(ValueError):
        schedulers.get_scheduler("nope")
