"""The synthetic convergence floors of tests/test_quality_floors.py, held
by the port on the CPU: each row of wesep_tpu_torch.tools.validate_synthetic
's FLOORS at SMALL, end to end (shard build -> bin/train or bin/train_gan
-> bin/infer with device cpu, every kernel on its plain version), against
the JAX package's floor. The card runs the same battery in chip_smoke.py's
phase 20.

Slow-marked, as the JAX battery is: it trains six models to convergence.
"""

import pytest
import torch

from wesep_tpu_torch.tools.validate_synthetic import FLOORS, SMALL, run

torch.set_num_threads(1)  # one intra-op thread per test worker


@pytest.mark.slow
@pytest.mark.parametrize("name,kwargs,floor", FLOORS,
                         ids=[r[0] for r in FLOORS])
def test_port_synthetic_convergence_floor(tmp_path, name, kwargs, floor):
    sisnri = run(str(tmp_path / name), device="cpu", **SMALL, **kwargs)
    assert sisnri >= floor, (
        f"{name}: the port's synthetic SI-SNRi {sisnri:.2f} dB fell below "
        f"the floor {floor} dB")
