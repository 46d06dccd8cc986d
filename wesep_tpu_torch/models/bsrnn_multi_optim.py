"""BSRNN_Multi: BSRNN with self-estimated speech augmentation (SSA) in the
model, for multi-optimisation training (arXiv:2409.09589).

Counterpart of wesep_tpu/models/bsrnn_multi_optim.py. In train mode the
model runs a second separation pass with the same parameters whose
enrollment is its own DETACHED first estimate, turned into fbank by the
consistent frontend and embedded by the same speaker encoder, and returns
([s, self_s, spk_logits, self_logits], None) for the (loss_posi,
loss_weight) table (v2 bsrnn_multi_optim.yaml: SISDR at [[0, 1]] weighted
[[0.4, 0.6]]). In eval mode it returns (s, spk_logits), as BSRNN does.

The mode follows `self.training`, as the JAX package's `train` flag does,
not `torch.is_grad_enabled()`: a no-grad forward in train mode runs both
passes. In train mode the encoder's BatchNorm statistics move twice per
forward, first by the enrollment's batch, then by the estimate's. Under a
bf16 stream the f32 embedding promotes both passes after the fuse to f32,
so a train forward runs 24 f32 BiLSTM forwards and its backward 24 of each
f32 backward kernel.
"""

from wesep_tpu_torch.models.bsrnn import BSRNN
from wesep_tpu_torch.ops.stft import stft

__all__ = ["BSRNN_Multi"]


class BSRNN_Multi(BSRNN):
    def forward(self, mix, cue):
        nsample = mix.shape[-1]
        re, im = stft(mix, self.win, self.stride, window=self.window)
        x, sub_specs = self._band_split(re, im)
        embed, spk_logits = self._spk_embedding(cue)
        s = self._separate(x, sub_specs, embed, nsample)
        if not self.training:
            return s, spk_logits
        self_embed, self_logits = self._spk_embedding(s.detach(),
                                                      from_waveform=True)
        self_s = self._separate(x, sub_specs, self_embed, nsample)
        return [s, self_s, spk_logits, self_logits], None
