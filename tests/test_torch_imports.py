"""Import hygiene of the port: wesep_tpu_torch and chip_smoke.py import
nothing of JAX (jax, flax, optax) and nothing of the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wesep_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "wesep_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    # "wesep_tpu_torch" is the port itself, not the JAX package
    return module.split(".")[0] in FORBIDDEN


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("wesep_tpu.ops.stft")
    assert not _forbidden("wesep_tpu_torch.ops.stft")
    assert not _forbidden("jaxtyping_lookalike")


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_package_import_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, wesep_tpu_torch\n"
        "for m in pkgutil.walk_packages(wesep_tpu_torch.__path__, "
        "'wesep_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_the_speaker_branch_modules_are_checked():
    """The joint speaker branch's modules are among the files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("ops/fbank.py", "models/speaker/__init__.py",
                   "models/speaker/pooling.py", "models/speaker/resnet.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module



def test_the_gan_and_bsrnn_multi_modules_are_checked():
    """MetricGAN's and BSRNN_Multi's modules are among the files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("ops/pesq.py", "models/discriminator.py",
                   "models/bsrnn_multi_optim.py", "train/trainer_gan.py",
                   "bin/train_gan.py", "utils/score.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module


def test_the_bsrnn_feats_and_encoder_modules_are_checked():
    """BSRNN_Feats', ECAPA-TDNN's (both layouts) and CAM++'s modules, and
    the data-parallel train step's, are among the files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("models/bsrnn_feats.py", "models/speaker/ecapa.py",
                   "models/speaker/ecapa_ws.py", "models/speaker/campplus.py",
                   "train/trainer.py", "train/executor.py", "bin/train.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module


def test_the_online_mixing_modules_are_checked():
    """Online mixing's and the device simulation's modules, and the data
    tools, are among the files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("data/augment.py", "data/fram_rir.py",
                   "data/noise_store.py", "data/processor.py",
                   "data/dataset.py", "tools/__init__.py",
                   "tools/make_noise_db.py", "tools/make_shard_online.py",
                   "utils/profiling.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module
