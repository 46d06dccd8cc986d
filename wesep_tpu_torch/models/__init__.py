"""Model registry (counterpart of wesep_tpu.models.get_model)."""

__all__ = ["get_model"]


def get_model(model_name: str):
    """Model class by name: BSRNN and ConvTasNet (SpEx+) are ported."""
    if model_name.startswith("ConvTasNet"):
        from wesep_tpu_torch.models.convtasnet import ConvTasNet

        return ConvTasNet
    if model_name == "BSRNN":
        from wesep_tpu_torch.models.bsrnn import BSRNN

        return BSRNN
    raise NotImplementedError(
        f"model {model_name!r} is not ported to wesep_tpu_torch yet "
        "(ROADMAP.md lists the order)"
    )
