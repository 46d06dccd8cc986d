"""The released models' names, and a model dir made loadable.

Counterpart of wesep_tpu/cli/hub.py without its download: this port
fetches nothing, so `Hub.get_model` raises and names the way round, a
local model dir passed with -p/--pretrain. `Hub._normalize_model_dir` makes
an unpacked release archive loadable by the extractor: it lifts a single
top-level folder and converts the reference's `avg_model.pt` into the
port bundle `avg_model.ckpt` (tools/convert_torch_checkpoint.py).
"""

import os

__all__ = ["Hub"]


class Hub:
    Assets = {
        "english": "bsrnn_ecapa_vox1.tar.gz",
        "chinese": "bsrnn_ecapa_cnceleb.tar.gz",
    }

    @staticmethod
    def get_model(lang: str) -> str:
        if lang not in Hub.Assets:
            raise ValueError(
                f"no pretrained model for language {lang!r}; "
                f"available: {sorted(Hub.Assets)}")
        raise RuntimeError(
            f"wesep_tpu_torch downloads no models: unpack "
            f"{Hub.Assets[lang]} yourself and pass its dir (config.yaml + "
            "avg_model.ckpt or avg_model.pt) with -p/--pretrain")

    @staticmethod
    def _normalize_model_dir(model_dir: str) -> None:
        """Lift a single top-level folder of an unpacked archive, and
        convert a reference `avg_model.pt` into `avg_model.ckpt` where the
        dir has no bundle yet."""
        entries = [e for e in os.listdir(model_dir) if not e.startswith(".")]
        if len(entries) == 1 and os.path.isdir(
                os.path.join(model_dir, entries[0])):
            sub = os.path.join(model_dir, entries[0])
            for item in os.listdir(sub):
                os.replace(os.path.join(sub, item),
                           os.path.join(model_dir, item))
            os.rmdir(sub)
        ckpt = os.path.join(model_dir, "avg_model.ckpt")
        pt = os.path.join(model_dir, "avg_model.pt")
        if not os.path.exists(ckpt) and os.path.exists(pt):
            from wesep_tpu_torch.tools.convert_torch_checkpoint import convert

            convert(pt, os.path.join(model_dir, "config.yaml"), ckpt)
