"""Weight bridge: JAX (flax) BSRNN param tree -> port state_dict.

The port names every parameter as the JAX tree does and keeps its shape
(Dense/einsum kernels [in, out], LSTM weights wx_* [D, 4H], wh_* [H, 4H]
and one summed bias b_* [4H]), so the map is a flatten of the nested dict
with '.' between levels:

    bn_norm_{g}.{scale,bias}            bn_proj_{g}.{kernel,bias}
    fuse_{j}.Dense_0.{kernel,bias}      fuse_{j}.FiLM_0.{gamma_i,beta_i}.*
    bsnet_{j}.{band_rnn,band_comm}.{norm_scale,norm_bias,
        rnn.{wx_f,wh_f,b_f,wx_b,wh_b,b_b},proj.{kernel,bias}}
    mask_{norm,fc1,fc2,out}_{g}.*       spk_transform.Dense_{i}.*

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

__all__ = ["bsrnn_state_dict_from_jax", "load_jax_params",
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


def bsrnn_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX BSRNN params (nested dict) -> port BSRNN state_dict (f32)."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in _flatten(params).items()
    }


def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load JAX params into a port model in place (strict: every name and
    shape must match)."""
    model.load_state_dict(bsrnn_state_dict_from_jax(params), strict=True)
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
