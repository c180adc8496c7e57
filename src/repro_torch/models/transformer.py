"""Decoder LM, dense family, with the layer-granular API of
``repro/models/transformer.py``.

Parameters are plain dicts with blocks STACKED on a leading [L, ...]
axis (the JAX package's layout, so weights map 1:1 through
``repro_torch.convert``); the pipeline runtime slices ``blocks[i]`` per
layer, the paper's unit of planning, state copy and sync.

``fuse="fused"`` (what ``"auto"`` resolves to) routes the QKV projection
and the residual-add + RMSNorm block epilogue through
``kernels/ops.py``, ``attn_impl="kernel"`` (what ``"auto"`` resolves
to) routes attention through ``ops.flash_attention``, and
``ssd_impl="kernel"`` (what ``"auto"`` resolves to) the Mamba2 SSD scan
through ``ops.ssd``: the CUDA kernels on a CUDA tensor, the plain
versions on a CPU tensor, so none needs a probe.  The dense, SSM
(mamba2) and hybrid (hymba: attention and Mamba heads in parallel)
families are ported; the MoE, multimodal and decode paths come with
later slices and raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (cross_entropy, embed, init_embedding,
                                       init_mlp, init_rms_norm, mlp, rms_norm,
                                       unembed)
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class Model:
    arch: ArchConfig
    dtype: torch.dtype = torch.bfloat16  # activations; parameters are fp32
    attn_impl: str = "blocked"          # blocked | naive | kernel | auto
    ssd_impl: str = "chunked"           # chunked | scan | kernel | auto
    fuse: str = "auto"                  # auto | fused | none

    def __post_init__(self):
        a = self.arch
        if a.moe is not None:
            raise NotImplementedError("MoE blocks are ported in the MoE "
                                      "slice (ROADMAP queue 1)")
        if a.frontend is not None:
            raise NotImplementedError("multimodal frontends are not ported "
                                      "yet (ROADMAP queue 1)")
        if self.attn_impl == "auto":
            self.attn_impl = "kernel"
        if self.attn_impl not in ("naive", "blocked", "kernel"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.ssd_impl == "auto":
            self.ssd_impl = "kernel"
        if self.ssd_impl not in ("chunked", "scan", "kernel"):
            raise ValueError(f"unknown ssd_impl {self.ssd_impl!r}")
        if self.fuse == "auto":
            self.fuse = "fused"
        if self.fuse not in ("fused", "none"):
            raise ValueError(f"unknown fuse {self.fuse!r}")

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict:
        """Same shapes and scales as the JAX package, drawn from ``gen``
        on its device (the numbers differ: use ``repro_torch.convert``
        to run on the JAX package's weights)."""
        a, pd = self.arch, torch.float32
        params = {"embed": init_embedding(gen, a.vocab_size, a.d_model, pd)}
        blocks = [self._init_block(gen) for _ in range(a.num_layers)]
        params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
        params["final_norm"] = init_rms_norm(a.d_model, pd, gen.device)
        if not a.tie_embeddings:
            params["head"] = init_embedding(gen, a.vocab_size, a.d_model, pd)
        return params

    def _init_block(self, gen: torch.Generator) -> Dict:
        a, pd = self.arch, torch.float32
        p: Dict = {"ln1": init_rms_norm(a.d_model, pd, gen.device)}
        if a.family == "ssm":
            p["mamba"] = ssm_lib.init_mamba(gen, a, pd)
            return p
        p["attn"] = attn_lib.init_attention(gen, a, pd)
        if a.hybrid_parallel_heads:
            p["mamba"] = ssm_lib.init_mamba(gen, a, pd)
        p["ln2"] = init_rms_norm(a.d_model, pd, gen.device)
        if a.d_ff:
            p["mlp"] = init_mlp(gen, a.d_model, a.d_ff, a.mlp_variant, pd)
        return p

    # ------------------------------------------------------------------
    # Single block (the pipeline runtime's unit)
    # ------------------------------------------------------------------
    def block(self, bp: Dict, x: torch.Tensor, aux: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.arch
        h = self._norm(bp["ln1"], x)
        if a.family == "ssm":
            x = x + ssm_lib.mamba(bp["mamba"], a, h, evaluator=self.ssd_impl)
            return x, aux
        fused = self.fuse == "fused"
        branch = attn_lib.attention(bp["attn"], a, h, impl=self.attn_impl,
                                    fused=fused)
        if a.hybrid_parallel_heads:
            branch = 0.5 * (branch + ssm_lib.mamba(bp["mamba"], a, h,
                                                   evaluator=self.ssd_impl))
        if fused:
            # one pass over the residual: (x + branch) and its RMSNorm
            x, h = kops.fused_add_rmsnorm(x, branch, bp["ln2"].to(x.dtype),
                                          eps=a.rms_norm_eps)
        else:
            x = x + branch
            h = self._norm(bp["ln2"], x)
        if a.d_ff:
            x = x + mlp(bp["mlp"], h, a.mlp_variant)
        return x, aux

    def _norm(self, w, x):
        return rms_norm(w.to(x.dtype), x, self.arch.rms_norm_eps)

    def run_blocks(self, blocks: Dict, x: torch.Tensor, aux: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply a stacked slice of blocks (full model or one stage)."""
        n = tree_leaves(blocks)[0].shape[0]
        for i in range(n):
            x, aux = self.block(tree_map(lambda t: t[i], blocks), x, aux)
        return x, aux

    # ------------------------------------------------------------------
    # Full forward / loss
    # ------------------------------------------------------------------
    def hidden_states(self, params: Dict, tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward up to (and including) the final norm; no head."""
        x = embed(params["embed"], tokens, self.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux = self.run_blocks(params["blocks"], x, aux)
        return self._norm(params["final_norm"], x), aux

    def forward(self, params: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: [b, S] -> logits [b, S, V], aux loss."""
        x, aux = self.hidden_states(params, tokens)
        head = params.get("head", params["embed"])
        return unembed(head, x), aux

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        # labels are PRE-SHIFTED next-token targets; the final position
        # is excluded from the mean (the reference's S-1 reduction); a 0/1
        # ``mask`` excludes positions from it
        labels = batch["labels"]
        logits, aux = self.forward(params, batch["tokens"])
        mask = batch.get("mask")
        nll = cross_entropy(logits[:, :-1], labels[:, :-1],
                            mask[:, :-1] if mask is not None else None)
        return nll, {"nll": nll, "aux": aux}

    def decode_step(self, *a, **k):
        raise NotImplementedError("the decode path is ported in the serving "
                                  "slice (ROADMAP queue 1)")

    prefill = init_cache = decode_step
