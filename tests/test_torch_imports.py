"""Import hygiene of the port: wesep_tpu_torch and chip_smoke.py import
nothing of JAX (jax, flax, optax), no msgpack (the card's machine has none:
the port reads the JAX package's bundles itself) and nothing of the JAX
package."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "wesep_tpu")


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


def test_the_checkpoint_and_grid_modules_are_checked():
    """The msgpack bundle reader, the checkpoint module that uses it and
    the (data x model) grid are among the files checked; the reader's own
    name is not mistaken for msgpack."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("utils/msgpack_bundle.py", "train/checkpoint.py",
                   "train/mesh.py", "train/trainer_gan.py",
                   "models/tfgridnet.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module
    assert _forbidden("msgpack") and not _forbidden(
        "wesep_tpu_torch.utils.msgpack_bundle")


def test_the_recipe_stage_checkpoint_and_serving_modules_are_checked():
    """The scoring stage, the data tools, the reference checkpoints' maps
    and converter, the extractor with its VAD and hub, the model host, the
    export and the profiler are among the files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("utils/score.py", "utils/bss_eval.py", "utils/stoi.py",
                   "bin/score.py", "tools/make_shard_list_premix.py",
                   "tools/extract_embed.py", "tools/test_dataset.py",
                   "utils/torch_port.py", "tools/convert_torch_checkpoint.py",
                   "data/vad.py", "cli/__init__.py", "cli/utils.py",
                   "cli/hub.py", "cli/extractor.py", "runtime_host.py",
                   "bin/export.py", "utils/profiling.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module


def test_the_synthetic_validation_module_is_checked():
    """tools/validate_synthetic, the synthetic battery's entry point, is
    among the files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert os.path.join("wesep_tpu_torch", "tools",
                        "validate_synthetic.py") in names


def test_the_last_host_modules_are_checked():
    """utils/datadir_writer and tools/print_train_val_curve are among the
    files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("utils/datadir_writer.py",
                   "tools/print_train_val_curve.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module


def test_the_runtime_and_trace_modules_are_checked():
    """The C++ runtime's build script and the trace tools are among the
    files checked."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for module in ("runtime/__init__.py", "runtime/build.py",
                   "tools/op_profile.py", "tools/trace_step.py"):
        assert os.path.join("wesep_tpu_torch", module) in names, module


def test_the_ports_runtime_includes_only_its_own_sources():
    """Every `#include "..."` of the port's C++ sources names a file of
    wesep_tpu_torch/runtime/, and build.py compiles nothing under the
    JAX package's runtime/."""
    from wesep_tpu_torch.runtime import build

    sources = []
    for dirpath, _, names in os.walk(build.RUNTIME_DIR):
        sources += [os.path.join(dirpath, n) for n in names
                    if n.endswith((".h", ".cc"))]
    assert len(sources) >= 15
    for path in sources:
        with open(path) as f:
            for target in re.findall(r'^#include "([^"]+)"', f.read(), re.M):
                assert os.path.exists(
                    os.path.join(build.RUNTIME_DIR, target)), (path, target)
    assert build.RUNTIME_DIR == os.path.join(ROOT, "wesep_tpu_torch",
                                             "runtime")
    jax_runtime = os.path.join(ROOT, "runtime")
    for name, files in build.PROGRAMS.items():
        for rel in files:
            assert os.path.exists(os.path.join(build.RUNTIME_DIR, rel))
        assert not any(jax_runtime + os.sep in arg
                       or arg == "-I" + jax_runtime
                       for arg in build._command(name, "out")), name
