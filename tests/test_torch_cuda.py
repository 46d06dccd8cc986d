"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: on a host without a GPU every test here skips. On the card,
where neither JAX nor pytest-xdist need be installed, run them without the
suite's conftest and options:

    python -m pytest -o addopts="" --noconftest tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from wesep_tpu_torch.ops import cuda_lstm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tolerance(ref):
    """1e-4 in f32; 4 units in the last place at the largest |ref| in bf16
    (h is rounded to bf16 every step; a different sum order may flip one
    rounding)."""
    if ref.dtype == torch.float32:
        return 1e-4
    amax = max(ref.float().abs().max().item(), 2.0 ** -126)
    return 4 * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _args(device, b, t, d, h, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.2).to(device)  # noqa
    return (r(b, t, d).to(dtype), r(d, 4 * h), r(4 * h), r(h, 4 * h),
            r(d, 4 * h), r(4 * h), r(h, 4 * h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,h", [(8, 10, 64, 128), (13, 7, 128, 256),
                                     (1100, 2, 16, 32), (1, 1, 4, 4)])
def test_bilstm_layer_matches_plain(cuda, dtype, b, t, d, h):
    args = _args(cuda, b, t, d, h, dtype)
    before = cuda_lstm.bilstm_layer.launches
    y = cuda_lstm.bilstm_layer(*args)
    torch.cuda.synchronize()
    assert cuda_lstm.bilstm_layer.launches == before + 1
    assert y.dtype == dtype and y.shape == (b, t, 2 * h)
    ref = cuda_lstm.bilstm_layer_reference(*args)
    assert (y.float() - ref.float()).abs().max().item() <= _tolerance(ref)


def test_bilstm_layer_rejects_what_it_cannot_run(cuda):
    args = _args(cuda, 2, 3, 8, 8, torch.float32)
    with pytest.raises(TypeError):
        cuda_lstm.bilstm_layer(args[0].half(), *args[1:])
    with pytest.raises(ValueError):  # H above one thread per unit
        cuda_lstm.bilstm_layer(*_args(cuda, 2, 3, 8, 260, torch.float32))
    with pytest.raises(ValueError):  # a weight left on the host
        cuda_lstm.bilstm_layer(args[0], args[1].cpu(), *args[2:])
