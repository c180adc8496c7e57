"""Pipeline-parallel train and forward across stage ranks
(``repro/runtime/spmd_pipeline.py``).

Each rank of a ``"stage"`` axis of a ``ProcessMesh`` (``launch/mesh.py``)
owns L/S consecutive blocks of a uniform template (``stage_params``;
``L % S == 0``); the embedding, final norm and head are replicated on
every stage, as in the reference, where they live outside its
``shard_map``.  Beside other mesh axes (``("stage", "data")``, in either
order) each coordinate of the other axes is a stage group of its own,
the ranks sharing that coordinate: every group runs the whole pipeline
on the same microbatches, as the reference's ``P()`` spec of them makes
every coordinate do, and everything below happens within a group.  The
groups' ranks of one stage so hold bitwise-equal parameters after every
step (the microbatches are not split over the other axes: neither are
the reference's).  The schedule is the reference's: M + S - 1 ticks, and at
tick t stage s runs microbatch t - s when there is one.  Stage 0 embeds;
a stage hands its output to the next with ``collectives.send_hop`` and
the next takes it with ``recv_hop``; the last stage runs the final norm,
the head and the CE.  The loss (the mean of the microbatches' mean
next-token NLL) is returned on every rank.

Differentiating ``pipeline_loss`` runs the transposed schedule: the
autograd engine runs the ready node created last first, so every stage
visits its microbatches from M - 1 down to 0, receiving each cotangent
from the next stage before sending its own to the previous one (the
order ``runtime/collectives.py`` writes down).  The gradients of the
replicated parameters (the embedding on stage 0, the final norm and the
head on the last stage, a tied head on both) are summed across the stage
group;
the global-norm clip counts each element once; AdamW steps each stage's
blocks and the replicated leaves, which stay equal on every stage.

The reference runs a bubble tick's blocks on zeros and discards them;
here a stage idles through the ticks without a microbatch.  Its blocks
run without the MoE aux loss, as the reference's pipeline does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.models import Model
from repro_torch.models.layers import (cross_entropy, embed,
                                       fused_cross_entropy, unembed)
from repro_torch.optim import adamw
from repro_torch.runtime.collectives import recv_hop, send_hop
from repro_torch.runtime.spmd import apply_sharded
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map, tree_unflatten_like)


def stack_by_stage(params_blocks, num_stages: int):
    """[L, ...] stacked blocks -> [S, L/S, ...]."""
    L = tree_leaves(params_blocks)[0].shape[0]
    if L % num_stages:
        raise ValueError(f"{L} blocks do not split into {num_stages} "
                         f"uniform stages")
    return tree_map(lambda t: t.reshape(num_stages, L // num_stages,
                                        *t.shape[1:]), params_blocks)


def _stages(mesh, stage_axis: str) -> Tuple[int, int, Tuple[int, ...]]:
    """(S, this rank's stage, its stage group's ranks in stage order):
    the group of the ranks that share every other coordinate."""
    _, ranks = mesh.group(stage_axis)
    return mesh.size(stage_axis), mesh.axis_index(stage_axis), ranks


def stage_params(params: Dict, mesh, stage_axis: str = "stage") -> Dict:
    """This stage's tree: its L/S blocks and copies of the replicated
    leaves."""
    S, s, _ = _stages(mesh, stage_axis)
    blocks = tree_map(lambda t: t[s].contiguous().clone(),
                      stack_by_stage(params["blocks"], S))
    out = {k: tree_map(torch.clone, v) for k, v in params.items()
           if k != "blocks"}
    out["blocks"] = blocks
    return out


def gather_stages(params: Dict, mesh, stage_axis: str = "stage") -> Dict:
    """The full tree on every rank from each stage's ``stage_params``."""
    S, _, ranks = _stages(mesh, stage_axis)
    pg, _ = mesh.group(stage_axis)
    out = dict(params)
    out["blocks"] = tree_map(
        lambda t: mesh.transport.all_gather(t, pg, S, 0) if S > 1 else t,
        params["blocks"])
    return out


def _schedule(model: Model, params: Dict, mesh, stage_axis: str, M: int,
              feed: Callable[[int], torch.Tensor], act_shape, device
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """This stage's part of the M + S - 1 ticks: the last stage's block
    outputs (one per microbatch) and the hops' zero scalars."""
    S, s, ranks = _stages(mesh, stage_axis)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    outs, hops = [], []
    for t in range(M + S - 1):
        j = t - s
        if not 0 <= j < M:
            continue                    # a bubble: this stage idles
        x = (feed(j) if s == 0 else
             recv_hop(mesh, ranks[s - 1], act_shape, model.dtype, device))
        y, _ = model.run_blocks(params["blocks"], x, aux)
        if s == S - 1:
            outs.append(y)
        else:
            hops.append(send_hop(y, mesh, ranks[s + 1]))
    return outs, hops


def _head(model: Model, params: Dict, h: torch.Tensor) -> torch.Tensor:
    return model._norm(params["final_norm"], h)


def _broadcast_from_last(mesh, stage_axis: str, t: torch.Tensor
                         ) -> torch.Tensor:
    S, _, ranks = _stages(mesh, stage_axis)
    if S == 1:
        return t
    return mesh.transport.broadcast(t, mesh.group(stage_axis)[0], ranks[-1])


def pipeline_forward(model: Model, params: Dict, x_mb: torch.Tensor, mesh,
                     stage_axis: str = "stage") -> torch.Tensor:
    """Pipelined hidden-state forward.  ``params``: this stage's tree;
    x_mb: [M, b, s, d_model] pre-embedded microbatches (stage 0 reads
    them).  Returns the block stack's outputs [M, b, s, d_model] (before
    the final norm and head) on every rank."""
    S, s, _ = _stages(mesh, stage_axis)
    with torch.no_grad():
        outs, _ = _schedule(model, params, mesh, stage_axis, x_mb.shape[0],
                            lambda j: x_mb[j], x_mb.shape[1:], x_mb.device)
        res = torch.stack(outs) if s == S - 1 else torch.empty_like(x_mb)
        return _broadcast_from_last(mesh, stage_axis, res)


def pipeline_logits(model: Model, params: Dict, tokens_mb: torch.Tensor,
                    mesh, stage_axis: str = "stage") -> torch.Tensor:
    """Embed -> pipelined blocks -> final norm + head, on every rank.
    tokens_mb: [M, b, s]; returns fp32 logits [M, b, s, V]."""
    head = params.get("head", params["embed"])
    with torch.no_grad():
        x = torch.stack([embed(params["embed"], t, model.dtype)
                         for t in tokens_mb])
        h = pipeline_forward(model, params, x, mesh, stage_axis)
        return torch.stack([unembed(head, _head(model, params, y))
                            for y in h])


def pipeline_loss(model: Model, params: Dict, tokens_mb: torch.Tensor,
                  labels_mb: torch.Tensor, mesh,
                  stage_axis: str = "stage") -> torch.Tensor:
    """The mean over [M, b, s] microbatches of each one's mean
    next-token NLL, on every rank; differentiable in this stage's
    ``params`` (backward is the transposed schedule; the replicated
    leaves' gradients are this stage's part, summed across stages by
    ``pipeline_value_and_grad``).  ``model.loss_chunk`` > 0 takes the
    chunked CE."""
    S, s, _ = _stages(mesh, stage_axis)
    dev = tokens_mb.device
    M, b, sl = tokens_mb.shape
    outs, hops = _schedule(
        model, params, mesh, stage_axis, M,
        lambda j: embed(params["embed"], tokens_mb[j], model.dtype),
        (b, sl, model.arch.d_model), dev)
    if s != S - 1:
        value = _broadcast_from_last(
            mesh, stage_axis, torch.zeros((), dtype=torch.float32,
                                          device=dev))
        return value + torch.stack(hops).sum()
    head = params.get("head", params["embed"])
    nlls = []
    for j, y in enumerate(outs):
        h, lb = _head(model, params, y), labels_mb[j]
        if model.loss_chunk:
            nlls.append(fused_cross_entropy(h, head["table"], lb,
                                            model.loss_chunk))
        else:
            nlls.append(cross_entropy(unembed(head, h)[:, :-1], lb[:, :-1]))
    loss = torch.stack(nlls).mean()
    _broadcast_from_last(mesh, stage_axis, loss.detach())
    return loss


def _stage_specs(mesh, stage_axis: str, params: Dict) -> List[Tuple]:
    """Each leaf's layout as a spec: the blocks sharded over the stages
    along their (stacked) first dimension, the rest replicated."""
    return [((stage_axis,) + (None,) * (t.ndim - 1))
            if path.startswith("['blocks']") else (None,) * t.ndim
            for path, t in tree_leaves_with_path(params)]


def pipeline_value_and_grad(model: Model, params: Dict,
                            tokens_mb: torch.Tensor, labels_mb: torch.Tensor,
                            mesh, stage_axis: str = "stage"
                            ) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients of this stage's tree): the blocks' own, the
    replicated leaves' summed across the stages."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = pipeline_loss(model, tree_unflatten_like(params, leaves),
                             tokens_mb, labels_mb, mesh, stage_axis)
        # backward() rather than autograd.grad: the receive hops'
        # backward (which sends each cotangent on) must run although no
        # parameter lies behind it
        loss.backward()
    S, _, _ = _stages(mesh, stage_axis)
    pg, _ = mesh.group(stage_axis)
    grads = []
    for leaf, spec in zip(leaves, _stage_specs(mesh, stage_axis, params)):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        if spec[:1] != (stage_axis,) and S > 1:
            g = mesh.transport.all_reduce(g, pg)
        grads.append(g)
    return loss.detach(), tree_unflatten_like(params, grads)


def make_pipeline_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                             mesh, stage_axis: str = "stage") -> Callable:
    """(this stage's params, its AdamW state, tokens_mb, labels_mb) ->
    (params, state, {"loss", "lr", "grad_norm"}): the pipelined forward,
    the transposed backward and AdamW, params and moments updated in
    place."""
    def step(params, opt_state, tokens_mb, labels_mb):
        loss, grads = pipeline_value_and_grad(model, params, tokens_mb,
                                              labels_mb, mesh, stage_axis)
        specs = _stage_specs(mesh, stage_axis, params)
        opt2, stats = apply_sharded(opt_cfg, mesh, params,
                                    tree_leaves(grads), opt_state, specs,
                                    specs)
        return params, opt2, {"loss": loss, **stats}
    return step
