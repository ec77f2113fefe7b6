"""Transformer-CRF ("sup") model family: same decode and basecall as the
LSTM-CRF family, with a transformer encoder."""

from bonito_tpu_torch.crf.basecall import basecall
from bonito_tpu_torch.transformer.model import Model

__all__ = ["Model", "basecall"]
