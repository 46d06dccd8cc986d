"""Host data plane of the serving and training paths (numpy, no JAX)."""

from wesep_tpu_torch.data.dataset import (
    BatchLoader,
    Dataset,
    MultiWorkerLoader,
    tse_collate_fn,
    tse_collate_fn_2spk,
    tse_collate_fn_device,
)

__all__ = ["BatchLoader", "Dataset", "MultiWorkerLoader", "tse_collate_fn",
           "tse_collate_fn_2spk", "tse_collate_fn_device"]
