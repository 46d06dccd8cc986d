"""Weight bridge: JAX (flax) param trees -> port state_dicts.

The port names every parameter as the JAX tree does and keeps its shape
(Dense/einsum kernels [in, out], LSTM weights wx_* [D, 4H], wh_* [H, 4H]
and one summed bias b_* [4H]), so the map is a flatten of the nested dict
with '.' between levels:

    bn_norm_{g}.{scale,bias}            bn_proj_{g}.{kernel,bias}
    fuse_{j}.Dense_0.{kernel,bias}      fuse_{j}.FiLM_0.{gamma_i,beta_i}.*
    bsnet_{j}.{band_rnn,band_comm}.{norm_scale,norm_bias,
        rnn.{wx_f,wh_f,b_f,wx_b,wh_b,b_b},proj.{kernel,bias}}
    mask_{norm,fc1,fc2,out}_{g}.*       spk_transform.Dense_{i}.*

ConvTasNet (SpEx+) crosses the same way, since the port keeps flax's own
shapes there too (Conv1d `kernel` [k, in / groups, out] under `Conv_0`, or
in the module itself for a depthwise convolution; `ConvTranspose_0.kernel`
[k, in, out], spatially reversed; LayerNorm `scale`/`bias`), with two
additions: the BatchNorm statistics, which flax keeps in a second tree
`batch_stats` (`mean`, `var` beside the `scale`, `bias` of `params`), land
on the buffers of the same names, and the `CheckpointTCNBlock_{i}` names
that `remat=True` gives the TCN blocks become `TCNBlock_{i}`.

TF-GridNet crosses as a flatten too (flax nn.Conv's HWIO `conv.kernel`,
the `kernel` [*k, out, in] of its transposed convolutions `deconv` and
`{intra,inter}_linear`, LayerNorm `scale`/`bias`), and a `scan_layers` tree
is unstacked: its leaves under `blocks.block` carry a leading [n_layers]
axis, and layer i becomes `block_{i}` of the unrolled tree.

The joint BSRNN, TF-GridNet and DPCCN carry their speaker encoder's tree
(`spk_model_net` in BSRNN, `spk_model` in the other two: flax nn.Conv's
HWIO `kernel` without bias, BatchNorm `scale` / `bias`, Dense
`seg_*` / `pred_linear`), and their bridges take its `batch_stats` as the
ConvTasNet's does.

The speaker encoders cross the same way inside a joint model's subtree or
alone: ECAPA-TDNN's tpu layout (`layer1.Conv_0.kernel` [5, F, C], `bn1`,
`layer{2,3,4}.{conv_in,res2.conv_{i},conv_out}.Conv_0.*`, `bn_in`, `bn_mid`,
`bn_out`, `se.fc1` / `fc2`, `conv_agg`, `pool.linear1` / `linear2`,
`pool_bn`, `linear`), its wespeaker layout (`layer1.{conv,bn}`,
`res2.convs_{i}` / `bns_{i}`, `se.linear1` / `linear2`, `conv`, `pool`,
`bn`, `linear`, `bn2`) and CAM++ (`head` with HWIO convs, `tdnn`,
`block{s}_layer{i}.{bn1,conv1,bn2,cam.{linear_local,linear1,linear2}}`,
`transit{s}_{bn,conv}`, `out_bn`, `dense` without bias, `dense_bn` with
statistics only), each BatchNorm's `mean` / `var` from `batch_stats`. A
model that takes only frame features (BSRNN_Feats' cross path) has no
encoder head in either tree. BSRNN_Feats adds `cross_proj`,
`cross_att.{q,k,v,out}_proj`, `cross_fuse_{j}.Dense_0` (or `fuse_{j}` for
an embedding fuse) and band layers `bn_norm_{g}` / `bn_proj_{g}` three
channel blocks wide when it appends a TF map.

DPCCN crosses as a flatten: every conv block keeps its flax `conv.kernel`
(HWIO, or [*k, out, in] for the transposed ones) and `conv.bias`, the TCN
blocks their depthwise `dconv1.kernel` [3, 1, C] and `dconv2` Dense. The
tree is the same on every `conv_impl` (the Pallas route binds an `nn.Conv`
named `conv` too).

The CMGAN discriminator is the exception: the port keeps torch's layouts
there, so its bridge `discriminator_state_dict_from_jax` transposes conv
kernels HWIO -> OIHW (`conv_{i}.weight`) and Dense kernels [in, out] ->
[out, in] (`fc_0.weight`, `fc_final.weight`), and moves flax's
spectral-norm state, `batch_stats['SpectralNorm_{j}']['{layer}/kernel/u']`
and `.../sigma`, onto the buffers `{layer}.u` [1, out] and `{layer}.sigma`;
`in_scale_{i}`, `in_bias_{i}`, the PReLU alphas and `lsigmoid.slope` map
one for one.

The params are plain nested dicts of arrays (numpy, or anything
`np.asarray` takes), as `model.init(...)["params"]` or a msgpack bundle's
`models[0]` gives them; nothing of JAX is imported here.

The optimizer state crosses the same way: `optimizer_state_from_jax` takes
what `flax.serialization.to_state_dict` gives for the JAX package's optax
chain (Adam's `count`, `mu`, `nu` and the schedule's `count`, numpy
leaves) and returns what `trainer.Optimizer.load_state_dict` takes, so
both packages can take their next step from the same state.
"""

from typing import Dict

import numpy as np
import torch

__all__ = ["bsrnn_state_dict_from_jax", "convtasnet_state_dict_from_jax",
           "tfgridnet_state_dict_from_jax", "dpccn_state_dict_from_jax",
           "discriminator_state_dict_from_jax", "load_jax_params",
           "optimizer_state_from_jax"]


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if hasattr(value, "items"):  # dict, flax FrozenDict
            out.update(_flatten(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def bsrnn_state_dict_from_jax(params,
                              batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX BSRNN params and, for a joint model, its speaker encoder's
    BatchNorm statistics (nested dicts) -> port BSRNN state_dict (f32)."""
    return convtasnet_state_dict_from_jax(params, batch_stats)


def convtasnet_state_dict_from_jax(params,
                                   batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX ConvTasNet params and BatchNorm statistics (nested dicts) ->
    port ConvTasNet state_dict (f32)."""
    flat = _flatten(params)
    stats = _flatten(batch_stats or {})
    clash = set(flat) & set(stats)
    if clash:
        raise ValueError(f"names in both params and batch_stats: {clash}")
    flat.update(stats)
    return {
        k.replace("CheckpointTCNBlock_", "TCNBlock_"):
            torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flat.items()
    }


def _unstack_scan_layers(state) -> Dict[str, torch.Tensor]:
    """Leaves under `blocks.block.` ([n_layers, ...]) -> `block_{i}.`."""
    out = {}
    for name, value in state.items():
        if name.startswith("blocks.block."):
            rest = name[len("blocks.block."):]
            for i, layer in enumerate(value.unbind(0)):
                out[f"block_{i}.{rest}"] = layer.clone()
        else:
            out[name] = value
    return out


def tfgridnet_state_dict_from_jax(params,
                                  batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX TFGridNet params (nested dict; unrolled `block_{i}` or the
    `scan_layers` tree's stacked `blocks.block`) and, for a joint model,
    its speaker encoder's BatchNorm statistics -> port TFGridNet
    state_dict (f32)."""
    return _unstack_scan_layers(
        convtasnet_state_dict_from_jax(params, batch_stats))


def dpccn_state_dict_from_jax(params,
                              batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX DPCCN params and, for a joint model, its speaker encoder's
    BatchNorm statistics (nested dicts) -> port DPCCN state_dict (f32)."""
    return convtasnet_state_dict_from_jax(params, batch_stats)


def discriminator_state_dict_from_jax(params, batch_stats
                                      ) -> Dict[str, torch.Tensor]:
    """JAX CMGANDiscriminator params and spectral-norm `batch_stats` (nested
    dicts) -> port CMGANDiscriminator state_dict (f32, torch layouts)."""
    out = {}
    for name, value in _flatten(params).items():
        value = np.array(value, dtype=np.float32)
        if name.endswith(".kernel"):
            layer = name[:-len(".kernel")]
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 \
                else value.T
            name = layer + ".weight"
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    for stats in batch_stats.values():  # SpectralNorm_{j}
        for key, value in stats.items():
            layer, _, leaf = key.split("/")  # '{layer}/kernel/{u|sigma}'
            out[f"{layer}.{leaf}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return out


def load_jax_params(model: torch.nn.Module, params,
                    batch_stats=None) -> torch.nn.Module:
    """Load JAX params (and BatchNorm statistics) into a port model in
    place (strict: every name and shape must match)."""
    model.load_state_dict(_unstack_scan_layers(
        convtasnet_state_dict_from_jax(params, batch_stats)), strict=True)
    return model


def _find_adam(tree):
    """The {count, mu, nu} dict of optax's scale_by_adam inside a
    serialized chain (however `chain` and `multi_transform` nest it)."""
    if not hasattr(tree, "items"):
        return None
    if {"count", "mu", "nu"} <= set(tree.keys()):
        return tree
    for value in tree.values():
        found = _find_adam(value)
        if found is not None:
            return found
    return None


def optimizer_state_from_jax(opt_state) -> dict:
    """Serialized optax chain state -> `trainer.Optimizer` state dict
    {"count", "mu", "nu"}, moments by flattened parameter name (f32).
    Frozen parameters carry no moments on either side."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer "
                         "state")

    def moments(tree):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in _flatten(tree).items()}

    return {"count": int(np.asarray(adam["count"])),
            "mu": moments(adam["mu"]), "nu": moments(adam["nu"])}
