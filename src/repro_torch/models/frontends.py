"""Modality frontend projector (``repro.models.frontends``).

The VLM vision encoder (InternViT) and the audio codec (EnCodec) are the
reference's carve-out and are not implemented: callers hand in precomputed
patch embeddings (``batch["frontend_embeds"]``) or discrete codec tokens.
This module only maps frontend embeddings into the decoder's d_model.
"""
from __future__ import annotations

from repro_torch.models.layers import dense_init


def frontend_init(gen, d_frontend: int, d_model: int, dtype):
    return {"proj": dense_init(gen, (d_frontend, d_model), dtype)}


def project_frontend(params, embeds):
    """embeds: (B, P, d_frontend) -> (B, P, d_model)."""
    return embeds.to(params["proj"].dtype) @ params["proj"]
