"""The port's C++ serving runtime: `separate_main` over an embedded CPython
that serves `wesep_tpu_torch.runtime_host` (counterpart of the JAX
package's `runtime/`). `build.py` compiles it with g++."""
