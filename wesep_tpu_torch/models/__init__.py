"""Model registry (counterpart of wesep_tpu.models.get_model)."""

__all__ = ["get_model"]


def get_model(model_name: str):
    """Model class by name (prefix dispatch, as wesep_tpu.models.get_model):
    BSRNN, BSRNN_Multi, BSRNN_Feats, ConvTasNet (SpEx+), TFGridNet, DPCCN
    and the CMGAN discriminator are ported."""
    if model_name.startswith("ConvTasNet"):
        from wesep_tpu_torch.models.convtasnet import ConvTasNet

        return ConvTasNet
    if model_name.startswith("BSRNN_Multi"):
        from wesep_tpu_torch.models.bsrnn_multi_optim import BSRNN_Multi

        return BSRNN_Multi
    if model_name.startswith("BSRNN_Feats"):
        from wesep_tpu_torch.models.bsrnn_feats import BSRNN_Feats

        return BSRNN_Feats
    if model_name == "BSRNN":
        from wesep_tpu_torch.models.bsrnn import BSRNN

        return BSRNN
    if model_name.startswith("DPCCN"):
        from wesep_tpu_torch.models.dpccn import DPCCN

        return DPCCN
    if model_name.startswith("TFGridNet"):
        from wesep_tpu_torch.models.tfgridnet import TFGridNet

        return TFGridNet
    if model_name.startswith("CMGAN"):
        from wesep_tpu_torch.models.discriminator import CMGANDiscriminator

        return CMGANDiscriminator
    raise NotImplementedError(
        f"model {model_name!r} is not ported to wesep_tpu_torch yet "
        "(ROADMAP.md lists the order)"
    )
