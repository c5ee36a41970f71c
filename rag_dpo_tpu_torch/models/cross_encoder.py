"""Cross-encoder reranker model (Jina-reranker-v2 class) in PyTorch.

Port of `rag_dpo_tpu/models/cross_encoder.py`: an XLM-RoBERTa backbone with
a scalar relevance head on CLS, evaluated in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from .encoder import EncoderConfig, TransformerEncoder


class CrossEncoderModel(nn.Module):
    """[B, S] token ids of 'query </s> passage' pairs → [B] f32 scores.

    `with_head_dense=True` matches the RoBERTa classification head
    (dense → tanh → out_proj); False is a bare scalar head on CLS.
    """

    def __init__(self, config: EncoderConfig, with_head_dense: bool = True):
        super().__init__()
        self.config = config
        self.with_head_dense = with_head_dense
        h = config.hidden_size
        self.encoder = TransformerEncoder(config)
        if with_head_dense:
            self.head_dense = nn.Linear(h, h)
        self.classifier = nn.Linear(h, 1)

    def forward(self, input_ids, lengths=None):
        if lengths is None:
            lengths = (input_ids != self.config.pad_token_id).sum(dim=1)
        hidden = self.encoder(input_ids, lengths)
        cls = hidden[:, 0, :].float()
        if self.with_head_dense:
            cls = torch.tanh(self.head_dense(cls))
        return self.classifier(cls)[:, 0]
