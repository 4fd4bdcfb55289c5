"""Modality frontend stubs: the port of the reference's
``repro/models/multimodal.py``.

The configs specify the transformer backbone only; the frontend takes
precomputed frame or patch embeddings.

* hubert-xlarge: the CNN feature extractor is stubbed — inputs are
  precomputed 512-d frame features, projected to d_model.
* llava-next: the CLIP tower is stubbed — inputs are precomputed 1024-d
  patch embeddings for the anyres tiles, projected by the 2-layer MLP
  connector and prepended to the token embeddings.

The inputs come from outside the model, so their products promote as in
JAX (f32 features against bf16 weights give f32).  On a mesh ``proj`` and
``w1`` are column-parallel and ``w2`` row-parallel (its partials summed
in f32), the frames and patches split over the batch axes.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import context as dctx
from repro_torch.models.layers import _init, _mm, _row_parallel


def audio_frontend_init(gen, d_in, d_model, dtype=torch.bfloat16):
    return {"proj": _init(gen, (d_in, d_model), dtype=dtype)}


def audio_frontend(p, feats):
    """feats: (B, S, d_in) precomputed frame features -> (B, S, D).  On a
    mesh the output's gradient is taken at its own placements: the
    backward's norms may hand it back split along the sequence, and the
    product's backward flattens (B, S) into one dim."""
    return dctx.grad_as_input(_mm(feats, p["proj"]))


def vision_connector_init(gen, d_vis, d_model, dtype=torch.bfloat16):
    return {"w1": _init(gen, (d_vis, d_model), dtype=dtype),
            "w2": _init(gen, (d_model, d_model), dtype=dtype)}


def vision_connector(p, patches):
    """patches: (B, P, d_vis) precomputed anyres tile embeddings; the GELU
    (tanh form) in f32, then cast to the patches' dtype."""
    h = torch.nn.functional.gelu(_mm(patches, p["w1"]).float(),
                                 approximate="tanh")
    return _row_parallel(h.to(patches.dtype), p["w2"])
