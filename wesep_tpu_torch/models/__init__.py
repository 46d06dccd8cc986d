"""Model registry (counterpart of wesep_tpu.models.get_model)."""

__all__ = ["get_model"]


def get_model(model_name: str):
    """Model class by name (prefix dispatch, as wesep_tpu.models.get_model):
    BSRNN, ConvTasNet (SpEx+) and TFGridNet are ported."""
    if model_name.startswith("ConvTasNet"):
        from wesep_tpu_torch.models.convtasnet import ConvTasNet

        return ConvTasNet
    if model_name == "BSRNN":
        from wesep_tpu_torch.models.bsrnn import BSRNN

        return BSRNN
    if model_name.startswith("TFGridNet"):
        from wesep_tpu_torch.models.tfgridnet import TFGridNet

        return TFGridNet
    raise NotImplementedError(
        f"model {model_name!r} is not ported to wesep_tpu_torch yet "
        "(ROADMAP.md lists the order)"
    )
