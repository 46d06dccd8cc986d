from setuptools import find_packages, setup

setup(
    name="wesep-tpu",
    version="0.1.0",
    description="TPU-native target speaker extraction framework",
    packages=find_packages(include=["wesep_tpu", "wesep_tpu.*",
                                    "wesep_tpu_torch", "wesep_tpu_torch.*"]),
    # CUDA sources of the PyTorch port, built with nvcc at first use, and
    # its C++ serving runtime's sources, built with g++ at first use
    package_data={"wesep_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                      "runtime/*/*.h", "runtime/*/*.cc"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "pyyaml",
    ],
    entry_points={
        "console_scripts": [
            "wesep-tpu = wesep_tpu.cli.extractor:main",
        ],
    },
)
