"""runtime_host and the profiler in the port.

runtime_host on a model dir and on its export dir (bin/export) gives the
eager forward's output bit for bit, and on the model dir (the JAX
package's msgpack bundle) within 5e-4 of the largest sample of the JAX
runtime_host's on the same dir; the JAX export's manifest has the port's
keys; profiling.trace writes a Chrome trace that holds the operators.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from test_torch_export import JAX_MANIFEST_KEYS
from test_torch_infer import MODEL_ARGS as V1_ARGS
from wesep_tpu import runtime_host as jax_host
from wesep_tpu.bin.export import export_model as jax_export_model
from wesep_tpu.models.bsrnn import BSRNN as JaxBSRNN
from wesep_tpu.train.checkpoint import save_checkpoint as jax_save
from wesep_tpu_torch import runtime_host
from wesep_tpu_torch.bin.export import ServedForward, export_model
from wesep_tpu_torch.models import get_model
from wesep_tpu_torch.utils.jax_params import bsrnn_state_dict_from_jax
from wesep_tpu_torch.utils.profiling import device_memory_stats, trace

torch.set_num_threads(1)  # one intra-op thread per test worker


def test_runtime_host_both_modes_and_the_jax_host(tmp_path):
    """A v1 BSRNN model dir holding the JAX package's msgpack bundle: the
    port's host on it and on its export dir, the eager forward, and the
    JAX host on the same dir."""
    rng = np.random.default_rng(2)
    samples = 4000
    mix = (0.1 * rng.standard_normal(samples)).astype(np.float32)
    e1, e2 = rng.standard_normal((2, 16)).astype(np.float32)
    params = JaxBSRNN(**V1_ARGS).init(
        jax.random.PRNGKey(1), np.zeros((1, 2000), np.float32),
        np.zeros((1, 16), np.float32), train=False)["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), params)
    root = str(tmp_path / "mdl")
    os.makedirs(root)
    jax_save(os.path.join(root, "avg_model.ckpt"), [params])
    config = {"model": {"tse_model": "BSRNN"},
              "model_args": {"tse_model": dict(V1_ARGS)},
              "dataset_args": {"resample_rate": 16000}}
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)

    model = get_model("BSRNN")(**V1_ARGS)
    model.load_state_dict(bsrnn_state_dict_from_jax(params))
    with torch.no_grad():
        want = ServedForward(model.eval())(
            torch.from_numpy(np.stack([mix, mix])),
            torch.from_numpy(np.stack([e1, e2]))).numpy()

    assert runtime_host.load(root, device="cpu") == 16000
    assert not runtime_host.expects_fbank()
    eager = runtime_host.separate(mix, e1, e2)
    np.testing.assert_array_equal(eager, want)

    export_model(config, os.path.join(root, "avg_model.ckpt"),
                 str(tmp_path / "export"), batch=2, samples=samples,
                 device="cpu")
    assert runtime_host.load(str(tmp_path / "export")) == 16000
    np.testing.assert_array_equal(runtime_host.separate(mix, e1, e2), want)
    # a shorter request is wrapped to the program's length
    short = runtime_host.separate(mix[:3000], e1, e2)
    assert short.shape == (2, 3000) and np.isfinite(short).all()
    with pytest.raises(ValueError, match="exported for cpu"):
        runtime_host.load(str(tmp_path / "export"), device="cuda")

    jax_host.load(root)
    theirs = np.asarray(jax_host.separate(mix, e1, e2))
    assert theirs.shape == eager.shape
    assert np.abs(eager - theirs).max() <= 5e-4 * np.abs(theirs).max()
    # the JAX package's manifest has the keys of the port's
    jax_export_model(os.path.join(root, "config.yaml"),
                     os.path.join(root, "avg_model.ckpt"),
                     str(tmp_path / "jax_export"), batch=2, samples=samples)
    with open(tmp_path / "jax_export" / "export.json") as f:
        assert set(json.load(f)) == JAX_MANIFEST_KEYS


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    model = get_model("BSRNN")(**dict(V1_ARGS, num_repeat=1)).eval()
    with trace(str(tmp_path / "prof")) as path:
        with torch.no_grad():
            model(torch.zeros(1, 2000), torch.zeros(1, 16))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("wesep::bilstm_layer" in n for n in names), sorted(names)[:20]
    assert device_memory_stats() == ({} if not torch.cuda.is_available()
                                     else device_memory_stats())
