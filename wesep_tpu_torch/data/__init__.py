"""Host data plane of the serving path (numpy, no JAX)."""

from wesep_tpu_torch.data.dataset import (
    BatchLoader,
    Dataset,
    tse_collate_fn,
    tse_collate_fn_2spk,
)

__all__ = ["BatchLoader", "Dataset", "tse_collate_fn", "tse_collate_fn_2spk"]
