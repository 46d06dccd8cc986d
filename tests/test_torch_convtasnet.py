"""Port parity: the whole ConvTasNet / SpEx+ against the JAX model.

The same numpy-seeded mixture and enrollment go through
wesep_tpu.models.convtasnet.ConvTasNet and, through the weight bridge
`convtasnet_state_dict_from_jax`, through the port's ConvTasNet at a small
size. With WESEP_TCN_PALLAS=force the JAX model runs its gLN blocks through
the Pallas kernel in interpret mode, as tests/test_pallas_tcn.py does; the
port runs the plain version of its CUDA kernels. Limits are relative to
each output's largest magnitude: 2e-4 (f32; both sides do the same
arithmetic in another order, through up to six blocks).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wesep_tpu.models import get_model as jax_get_model
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.models.convtasnet import ConvTasNet
from wesep_tpu_torch.utils.jax_params import (
    convtasnet_state_dict_from_jax,
    load_jax_params,
)

torch.set_num_threads(1)  # one intra-op thread per test worker

SPEX = dict(N=32, L=20, B=32, H=64, P=3, X=3, R=2, spk_emb_dim=16,
            norm="gLN", causal=False, skip_con=False,
            spk_fuse_type="concatConv", multi_fuse=True,
            encoder_type="Multi", decoder_type="Multi", joint_training=True,
            multi_task=True, spks_in_train=7)
T_MIX, T_ENR = 2000, 1500


def _wavs(seed, joint=True, emb_dim=16):
    rng = np.random.default_rng(seed)
    mix = (rng.standard_normal((2, T_MIX)) * 0.1).astype(np.float32)
    if joint:
        enroll = (rng.standard_normal((2, T_ENR)) * 0.1).astype(np.float32)
    else:
        enroll = rng.standard_normal((2, emb_dim)).astype(np.float32)
    return mix, enroll


def _jax_model(args, mix, enroll, seed=0):
    model = jax_get_model("ConvTasNet")(**args)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(mix),
                           jnp.asarray(enroll), train=True)
    return model, variables


def _randomise_stats(variables, seed):
    """BatchNorm statistics that are not the initial 0 / 1."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _close(got, want, limit=2e-4, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, atol=limit * np.abs(want).max(), rtol=0,
        err_msg=msg)


def _flat(outputs):
    ests, logits = outputs
    ests = list(ests) if isinstance(ests, (list, tuple)) else [ests]
    return ests + ([] if logits is None else [logits])


def test_registry_and_state_dict_names():
    assert get_model("ConvTasNet") is ConvTasNet
    mix, enroll = _wavs(0)
    _, variables = _jax_model(SPEX, mix, enroll)
    sd = convtasnet_state_dict_from_jax(variables["params"],
                                        variables["batch_stats"])
    port = ConvTasNet(**SPEX)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert sum(k.endswith((".mean", ".var")) for k in sd) == 12
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(port, variables["params"])  # strict: no statistics


def test_spex_eval_matches_jax(monkeypatch):
    monkeypatch.setenv("WESEP_TCN_PALLAS", "force")
    mix, enroll = _wavs(1)
    model, variables = _jax_model(SPEX, mix, enroll)
    variables = _randomise_stats(variables, 2)
    want = _flat(model.apply(variables, jnp.asarray(mix), jnp.asarray(enroll),
                             train=False))
    port = load_jax_params(ConvTasNet(**SPEX), variables["params"],
                           variables["batch_stats"]).eval()
    with torch.no_grad():
        got = _flat(port(torch.from_numpy(mix), torch.from_numpy(enroll)))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape
        _close(g, w, msg=f"output {i}")
    assert got[0].shape == (2, T_MIX) and got[3].shape == (2, 7)


def test_spex_train_mode_outputs_and_batch_stats_match_jax(monkeypatch):
    monkeypatch.setenv("WESEP_TCN_PALLAS", "force")
    mix, enroll = _wavs(3)
    model, variables = _jax_model(SPEX, mix, enroll)
    variables = _randomise_stats(variables, 4)
    want, new_state = model.apply(
        variables, jnp.asarray(mix), jnp.asarray(enroll), train=True,
        mutable=["batch_stats"])
    port = load_jax_params(ConvTasNet(**SPEX), variables["params"],
                           variables["batch_stats"]).train()
    got = _flat(port(torch.from_numpy(mix), torch.from_numpy(enroll)))
    for i, (g, w) in enumerate(zip(got, _flat(want))):
        _close(g, w, msg=f"output {i}")
    want_sd = convtasnet_state_dict_from_jax({}, new_state["batch_stats"])
    assert len(want_sd) == 12
    for name, w in want_sd.items():
        # moved by momentum 0.9 towards the batch's statistics
        _close(port.state_dict()[name], w.numpy(), limit=1e-5, msg=name)
        assert not np.allclose(
            w.numpy(), convtasnet_state_dict_from_jax(
                {}, variables["batch_stats"])[name].numpy())


def test_spex_gradients_match_jax(monkeypatch):
    """Gradients of a three-scale loss plus the logits w.r.t. every
    parameter, through the fused blocks on both sides: 5e-4 of each
    gradient's largest magnitude."""
    monkeypatch.setenv("WESEP_TCN_PALLAS", "force")
    args = dict(SPEX, X=2, R=1)
    mix, enroll = _wavs(5)
    model, variables = _jax_model(args, mix, enroll)

    def loss(params):
        outs, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(mix), jnp.asarray(enroll), train=True,
            mutable=["batch_stats"])
        return sum(jnp.sum(o ** 2) for o in _flat(outs))

    want = convtasnet_state_dict_from_jax(
        jax.jit(jax.grad(loss))(variables["params"]))
    port = load_jax_params(ConvTasNet(**args), variables["params"],
                           variables["batch_stats"]).train()
    outs = _flat(port(torch.from_numpy(mix), torch.from_numpy(enroll)))
    sum((o ** 2).sum() for o in outs).backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(grads) == set(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            grads[name].numpy(), w, atol=5e-4 * (np.abs(w).max() + 1e-8),
            rtol=0, err_msg=name)


@pytest.mark.parametrize("args", [
    dict(norm="cLN", skip_con=True),
    dict(norm="BN", spk_fuse_type="multiply", joint_training=False,
         multi_task=False, encoder_type=None, decoder_type=None),
    dict(spk_fuse_type="FiLM", multi_fuse=False, encoder_type="Deep",
         decoder_type=None, activate="sigmoid", use_spk_transform=True,
         causal=True, remat=True),
], ids=["cLN-skip", "BN-multiply-single", "FiLM-deep-causal-remat"])
def test_other_configurations_match_jax(monkeypatch, args):
    """Configurations off the kernel route (cLN, BN, skip connections) and
    the other encoders, decoders, fusions and activations, train mode."""
    monkeypatch.setenv("WESEP_TCN_PALLAS", "force")
    args = dict(SPEX, **args)
    mix, enroll = _wavs(6, joint=args["joint_training"])
    model, variables = _jax_model(args, mix, enroll)
    mutable = ["batch_stats"] if "batch_stats" in variables else False
    want = model.apply(variables, jnp.asarray(mix), jnp.asarray(enroll),
                       train=True, mutable=mutable)
    if mutable:
        want = want[0]
    port = load_jax_params(ConvTasNet(**args), variables["params"],
                           variables.get("batch_stats")).train()
    got = _flat(port(torch.from_numpy(mix), torch.from_numpy(enroll)))
    want = _flat(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, msg=f"output {i}")


def test_bf16_stream_stays_bf16_with_f32_parameters():
    """compute_dtype bfloat16: the inputs are cast, the parameters stay
    f32, every output keeps the stream's dtype and gradients come back
    f32."""
    mix, enroll = _wavs(8)
    torch.manual_seed(0)
    port = ConvTasNet(**SPEX).train()
    ests, logits = port(torch.from_numpy(mix).bfloat16(),
                        torch.from_numpy(enroll).bfloat16())
    assert all(e.dtype == torch.bfloat16 for e in ests)
    assert logits.dtype == torch.bfloat16
    (sum(e.float().pow(2).sum() for e in ests) + logits.float().sum()) \
        .backward()
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
