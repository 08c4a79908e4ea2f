"""InternVL2-style VLM (port of ``repro/models/vlm.py``): a ViT frontend
stub and the transformer backbone.

The vision frontend is a stub in the reference too: requests carry
precomputed patch embeddings (B, n_patches, d_model).  The language model
is the transformer (``models/transformer.py``) as it is; this module adds
the multimodal splice: a norm and a learned d x d projection of the
patches (``proj``: B1 on the card for a quant_sparse plan), prepended to
the prompt's embeddings, so a sequence's positions and KV pages start with
its n_patches patches (``api.prefix_len``).  ``forward`` and ``loss_fn``
train through the transformer's training forward after the same splice;
on a mesh the rank projects its data replica's patches, and the untied
head stays whole where the model axis does not divide the vocabulary
(internvl2-2b's 92553 rows), as in serving.
"""

from __future__ import annotations

import torch

from repro_torch.core.weight_plan import apply_linear
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def param_shapes(cfg) -> dict:
    """The transformer's params tree plus ``proj`` {"w" (d, d), "ln"}."""
    p = T.param_shapes(cfg)
    p["proj"] = {"w": ((cfg.d_model, cfg.d_model), "dense"),
                 "ln": L.norm_shapes(cfg.d_model, cfg.norm)}
    return p


def param_axes(cfg) -> dict:
    """The transformer's axes plus ``proj``'s."""
    a = T.param_axes(cfg)
    a["proj"] = {"w": ("d", "d"), "ln": L.norm_axes(cfg.norm)}
    return a


def init_params(cfg, seed: int = 0, *, device=None):
    """Random params with the reference's shapes and scales
    (``transformer.make_params``)."""
    return T.make_params(param_shapes(cfg), seed, device)


def n_params_exact(cfg) -> int:
    return T.count_params(param_shapes(cfg))


def unstack(cfg, params) -> dict:
    """The transformer's per-layer view, with ``proj`` kept."""
    if "layers" in params:
        return params
    return {**T.unstack(cfg, params), "proj": params["proj"]}


def _project(cfg, params, patches):
    """patches (B, P, d) -> their embeddings in the compute dtype."""
    x = L.apply_norm(params["proj"]["ln"], patches.to(getattr(torch, cfg.compute_dtype)),
                     cfg.norm)
    return apply_linear(x, params["proj"]["w"])


def prefill(cfg, params, tokens, patches, cache, *, use_kernel: bool = True):
    """The transformer's prefill over [projected patches; tokens]."""
    return T.prefill(cfg, params, tokens, cache, extra_embeds=_project(cfg, params, patches),
                     use_kernel=use_kernel)


def forward(cfg, params, tokens, patches):
    """tokens (B, S), patches (B, P, d) -> (logits over the text positions,
    aux): the transformer's training forward after the projected patches.
    ``params`` is the stacked tree of dense tensors."""
    return T.forward(cfg, params, tokens, extra_embeds=_project(cfg, params, patches))


def loss_fn(cfg, params, batch):
    """The transformer's loss over the text positions, after the projected
    ``batch["patches"]``.  On a mesh the replica's rows of the patches,
    tokens and labels are cut together, once (``transformer.replica_rows``),
    and only the replica's patches are projected."""
    rows = T.replica_rows(batch)
    return T.replica_loss(cfg, params, rows, extra_embeds=_project(cfg, params, rows["patches"]))


init_cache = T.init_cache
decode_step = T.decode_step
