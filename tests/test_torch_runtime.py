"""The port's C++ serving runtime (wesep_tpu_torch/runtime/) on the CPU.

wesep_tpu_torch/runtime/build.py builds separate_main, runtime_test and
fbank_dump with g++; the frontend's unit tests pass; separate_main --device
cpu on the joint BSRNN that tests/test_runtime.py builds (the JAX package's
weights, read by the port through utils/jax_params) is within 5e-4 of the
largest sample of the JAX runtime on the same wavs (with speaker features
its host on the features of the C++ frontend both share; without, its
binary), and its int16 wavs equal runtime_host.separate in-process written
the same way, bit for bit; a narrow wav-enrollment SpEx+ over a
two-utterance wav_scp equals runtime_host.separate in-process so, and
reports no kernel launch on the CPU; the C++ fbank is near the port's Kaldi
fbank and the JAX package's; a TF SavedModel dir is refused.

The JAX runtime is built into the test's own tmp dir (cmake,
-DWESEP_WITH_TF=OFF), so xdist workers do not share a build dir. Every
binary runs with OMP_NUM_THREADS=1, as this process runs torch on one
thread: the CPU's sums then come in the same order on both sides.
"""

import os
import shutil
import site
import struct
import subprocess
import wave

import numpy as np
import pytest
import torch
import yaml

from wesep_tpu_torch import runtime_host
from wesep_tpu_torch.data.wav_io import read_wav, write_wav
from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank

torch.set_num_threads(1)  # one intra-op thread per test worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
# tests/test_runtime.py's joint speaker-feat BSRNN
BSRNN_ARGS = {
    "spk_emb_dim": 32, "feature_dim": 8, "num_repeat": 1,
    "joint_training": True, "use_spk_transform": False,
    "spk_fuse_type": "multiply", "multi_fuse": False,
    "spk_model": "ResNet18",
    "spk_args": {"feat_dim": 80, "embed_dim": 32, "two_emb_layer": False},
    "spk_feat": True, "remat": False,
}
SPEX_ARGS = dict(N=16, L=20, B=16, H=32, P=3, X=2, R=1, spk_emb_dim=8,
                 norm="gLN", causal=False, skip_con=False,
                 spk_fuse_type="concatConv", multi_fuse=True,
                 encoder_type="Multi", decoder_type="Multi",
                 joint_training=True, multi_task=True, spks_in_train=3)
LIMIT = 5e-4  # of the largest sample, as tests/test_torch_runtime_host.py

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the runtime")


def write_float_wav(path, wav, sr=SR):
    """A mono IEEE float32 RIFF file: the engine reads its samples back
    exactly."""
    data = np.ascontiguousarray(wav, "<f4").tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, 4 * sr, 4, 32)
    with open(path, "wb") as f:
        f.write(header + b"data" + struct.pack("<I", len(data)) + data)


def read_pcm16(path):
    """A PCM16 wav's samples as int16."""
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def pcm16(wav):
    """float32 samples as separate_main writes them: clipped to [-1, 1],
    times 32767 in float32, truncated to int16."""
    return (np.clip(wav, -1.0, 1.0).astype(np.float32)
            * np.float32(32767.0)).astype(np.int16)


def run(cmd, env=None):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1",
                                   **(env or {})))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def port_build():
    from wesep_tpu_torch.runtime import build

    return build.build_all()


@pytest.fixture(scope="module")
def jax_separate_main(tmp_path_factory):
    if shutil.which("cmake") is None:
        pytest.skip("no cmake to build the JAX package's runtime")
    out = str(tmp_path_factory.mktemp("jax_runtime"))
    run(["cmake", "-B", out, "-S", os.path.join(REPO, "runtime"),
         "-DWESEP_WITH_TF=OFF"]
        + (["-G", "Ninja"] if shutil.which("ninja") else []))
    run(["cmake", "--build", out, "--target", "separate_main"])
    return os.path.join(out, "separate_main")


def separate_main(port_build, model_dir, out_dir, *flags):
    os.makedirs(out_dir, exist_ok=True)
    return run([port_build["separate_main"], "--model_path", model_dir,
                "--result_dir", out_dir, "--device", "cpu", *flags])


def fbank_dump(port_build, wav_path, out_path):
    frames, dim = map(int, run([port_build["fbank_dump"], wav_path,
                                out_path]).split())
    return np.fromfile(out_path, "<f4").reshape(frames, dim)


def test_runtime_unit_tests(port_build):
    from wesep_tpu_torch.runtime import build

    out = build.run_tests(port_build["runtime_test"])
    assert "TestFbankWithMeanNorm ok" in out


def jax_model_dir(root, spk_feat):
    """A model dir holding the JAX package's weights of
    tests/test_runtime.py's joint BSRNN (speaker features on or off)."""
    import jax
    import jax.numpy as jnp

    from wesep_tpu.models.bsrnn import BSRNN
    from wesep_tpu.train.checkpoint import save_checkpoint

    args = dict(BSRNN_ARGS, spk_feat=spk_feat)
    model = BSRNN(**args)
    cue = jnp.zeros((2, 50, 80)) if spk_feat else jnp.zeros((2, 4000))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((2, 4000)), cue, train=False)
    os.makedirs(root)
    save_checkpoint(os.path.join(root, "avg_model.ckpt"),
                    [variables["params"]],
                    batch_stats=[variables.get("batch_stats", {})])
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": {"tse_model": "BSRNN"},
                        "model_args": {"tse_model": args},
                        "dataset_args": {"resample_rate": SR}}, f)
    return root


@pytest.mark.parametrize("cue", ["fbank", "wav"])
def test_separate_main_against_the_jax_runtime(port_build, jax_separate_main,
                                               tmp_path, cue):
    """The port's separate_main against the JAX package's runtime on its
    weights and the same wavs (tests/test_runtime.py's tones).

    fbank cues (the speaker-feat BSRNN): against wesep_tpu.runtime_host,
    which the JAX binary calls, on the features the shared C++ frontend
    computes (fbank_dump). The JAX binary itself is not run here: its
    ForwardFunc (runtime/separate/separate_engine.cc:113-119) hands the host
    np.frombuffer views of two vectors that go out of scope before the
    call, so its model reads freed memory. wav cues (the model computes the
    fbank): against the JAX binary, whose int16 wav adds up to two steps of
    1/32768 to the limit. Either way the port's int16 wavs equal
    runtime_host.separate in-process written the same way, bit for bit, and
    that call's float32 output is what is held against the JAX side."""
    model_dir = jax_model_dir(str(tmp_path / "mdl"), cue == "fbank")
    ts = np.arange(8000) / SR
    mix = (0.4 * np.sin(2 * np.pi * 440 * ts)
           + 0.3 * np.sin(2 * np.pi * 1000 * ts)).astype(np.float32)
    e1 = (0.4 * np.sin(2 * np.pi * 440 * np.arange(6000) / SR)).astype(
        np.float32)
    e2 = (0.3 * np.sin(2 * np.pi * 1000 * np.arange(6000) / SR)).astype(
        np.float32)
    wavs = {}
    for name, wav in (("mix", mix), ("e1", e1), ("e2", e2)):
        wavs[name] = str(tmp_path / f"{name}.wav")
        write_wav(wavs[name], wav, SR)
    request = ["--wav_path", wavs["mix"], "--spk1_enroll", wavs["e1"],
               "--spk2_enroll", wavs["e2"]]
    out = separate_main(port_build, model_dir, str(tmp_path / "port"),
                        *request)
    assert f"{'fbank' if cue == 'fbank' else 'wav or embedding'} cues" in out
    assert "utt: decode" in out and "TOTAL: decode" in out
    served = np.stack([read_pcm16(str(tmp_path / "port" / f"utt-spk{i}.wav"))
                       for i in (1, 2)])

    mix_q = read_wav(wavs["mix"])[0][0]  # int16, as the engine read it
    if cue == "fbank":
        cues = [fbank_dump(port_build, wavs[n], str(tmp_path / f"{n}.f32"))
                for n in ("e1", "e2")]
        from wesep_tpu import runtime_host as jax_host

        jax_host.load(model_dir)
        theirs = np.asarray(jax_host.separate(mix_q, *cues))
        slack = 0.0
    else:
        cues = [read_wav(wavs[n])[0][0] for n in ("e1", "e2")]
        env = {"WESEP_PYTHONPATH": ":".join([REPO] + site.getsitepackages()),
               "JAX_PLATFORMS": "cpu", "WESEP_JAX_PLATFORMS": "cpu"}
        os.makedirs(tmp_path / "jax")
        run([jax_separate_main, "--model_path", model_dir, "--result_dir",
             str(tmp_path / "jax"), *request], env)
        theirs = np.stack([
            read_wav(str(tmp_path / "jax" / f"utt-spk{i}.wav"))[0][0]
            for i in (1, 2)])
        slack = 2 / 32768
    runtime_host.load(model_dir, device="cpu")
    assert runtime_host.expects_fbank() == (cue == "fbank")
    ours = runtime_host.separate(mix_q, *cues)
    np.testing.assert_array_equal(served, pcm16(ours))
    assert ours.shape == theirs.shape == (2, 8000)
    err = np.abs(ours - theirs).max()
    assert err <= LIMIT * np.abs(theirs).max() + slack, err


def test_the_cpp_fbank_is_the_ports_fbank(port_build, tmp_path):
    """fbank_dump (the engine's features) against ops/fbank's Kaldi fbank
    with CMVN, at int16 scale and no dither."""
    rng = np.random.default_rng(3)
    wav = (0.3 * rng.standard_normal(9600)).astype(np.float32)
    path = str(tmp_path / "e.wav")
    write_float_wav(path, wav)
    got = fbank_dump(port_build, path, str(tmp_path / "e.f32"))
    want = apply_cmvn(kaldi_fbank(torch.from_numpy(wav), sample_rate=SR,
                                  num_mel_bins=80, dither=0.0,
                                  input_scale=32768.0)).numpy()
    assert got.shape == want.shape == (58, 80)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_the_cpp_fbank_is_the_jax_packages_fbank(port_build, tmp_path):
    """fbank_dump against the JAX package's Kaldi fbank (ops/fbank.py) with
    each bin's mean over time taken out, as the engine takes it out, at
    int16 scale and no dither."""
    import jax.numpy as jnp

    from wesep_tpu.ops.fbank import kaldi_fbank as jax_kaldi_fbank

    rng = np.random.default_rng(3)
    wav = (0.3 * rng.standard_normal(9600)).astype(np.float32)
    path = str(tmp_path / "e.wav")
    write_float_wav(path, wav)
    got = fbank_dump(port_build, path, str(tmp_path / "e.f32"))
    feats = np.asarray(jax_kaldi_fbank(jnp.asarray(wav), sample_rate=SR,
                                       num_mel_bins=80, dither=0.0,
                                       input_scale=32768.0))
    want = feats - feats.mean(axis=0, keepdims=True)
    assert got.shape == want.shape == (58, 80)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_separate_main_spex_wav_enrollment(port_build, tmp_path):
    """A narrow SpEx+ (wav cues) over a two-utterance wav_scp: the int16
    outputs equal runtime_host.separate in-process written the same way, bit
    for bit; on the CPU the engine reports no kernel launch."""
    from wesep_tpu_torch.models import get_model
    from wesep_tpu_torch.train.checkpoint import save_checkpoint, split_state

    torch.manual_seed(4)
    model = get_model("ConvTasNet")(**SPEX_ARGS)
    model_dir = str(tmp_path / "spex")
    os.makedirs(model_dir)
    params, buffers = split_state(model)
    save_checkpoint(os.path.join(model_dir, "avg_model.ckpt"), [params],
                    batch_stats=[buffers])
    with open(os.path.join(model_dir, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": {"tse_model": "ConvTasNet"},
                        "model_args": {"tse_model": SPEX_ARGS},
                        "dataset_args": {"resample_rate": SR}}, f)
    rng = np.random.default_rng(5)
    rows, inputs = [], {}
    for key, samples in (("short", 4000), ("long", 11000)):
        inputs[key] = [(0.2 * rng.standard_normal(n)).astype(np.float32)
                       for n in (samples, 6000, 5000)]
        paths = [str(tmp_path / f"{key}_{j}.wav") for j in range(3)]
        for path, wav in zip(paths, inputs[key]):
            write_float_wav(path, wav)
        rows.append(" ".join([key] + paths))
    scp = str(tmp_path / "wav.scp")
    with open(scp, "w") as f:
        f.write("\n".join(rows) + "\n")
    out = separate_main(port_build, model_dir, str(tmp_path / "out"),
                        "--wav_scp", scp, "--num_threads", "2")
    assert "wav or embedding cues" in out and "--num_threads ignored" in out
    assert "short: decode" in out and "long: decode" in out
    assert out.splitlines()[-1] == "kernel launches: {}"

    from wesep_tpu_torch.ops import cuda_tcn

    cuda_tcn.tcn_block_gln.launches = 3  # load sets every counter to 0
    runtime_host.load(model_dir, device="cpu")
    assert runtime_host.launches() == {}
    assert not runtime_host.expects_fbank()
    for key, (mix, e1, e2) in inputs.items():
        want = runtime_host.separate(mix, e1, e2)
        for i in (1, 2):
            path = str(tmp_path / "out" / f"{key}-spk{i}.wav")
            assert read_wav(path)[1] == SR
            np.testing.assert_array_equal(read_pcm16(path),
                                          pcm16(want[i - 1]))


def test_separate_main_refuses_a_savedmodel(port_build, tmp_path):
    os.makedirs(tmp_path / "sm" / "saved_model")
    (tmp_path / "sm" / "saved_model" / "saved_model.pb").write_bytes(b"")
    proc = subprocess.run(
        [port_build["separate_main"], "--model_path", str(tmp_path / "sm"),
         "--wav_path", "mix.wav", "--spk1_enroll", "a.wav", "--spk2_enroll",
         "b.wav"], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert "TensorFlow SavedModel" in proc.stderr
    assert "ROADMAP.md A.3" in proc.stderr
