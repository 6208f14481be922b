"""Train-step factory: microbatched grad accumulation, chunked CE loss,
optional int8 gradient compression with error feedback, AdamW + WSD.

Counterpart of ``repro.training.train``. ``make_train_step(cfg, ...)``
returns ``train_step(state, batch) -> (state, metrics)``; in PyTorch's
idiom the step updates the state's params and moments IN PLACE (the
reference's ``donate_argnums`` has no counterpart) and returns the state.
On DTensor state and batch (laid out by ``launch/sharding.py``) the step is
the reference's pjit step: the gradients' partial sums are reduced to the
params' layout (``reduce_like``) before anything reads them.
Batch contract (tensors on the params' device):

    {"inputs": (B, S) int tokens  OR (B, S, d) embeddings (audio stub),
     "labels": (B, S) int,
     "enc_states": (B, n_media, d)  (vlm only)}
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch import dtensor as dtm
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.training import tree as T
from repro_torch.training.compression import compress_with_feedback, init_error_buffer
from repro_torch.training.losses import chunked_softmax_xent
from repro_torch.training.optimizer import AdamW, AdamWState, clip_by_global_norm


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    step: torch.Tensor
    error_buf: Any = None          # int8-compression error feedback (optional)


def init_train_state(cfg: ModelConfig, params, optimizer: AdamW, *, compression: bool = False):
    device = T.leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=device),
        error_buf=init_error_buffer(params) if compression else None,
    )


def _loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *, remat: bool,
          loss_chunk: int) -> torch.Tensor:
    h = forward(params, cfg, batch["inputs"], enc_states=batch.get("enc_states"), remat=remat)
    return chunked_softmax_xent(h, params["embed"]["table"], batch["labels"],
                                chunk=loss_chunk, final_softcap=cfg.final_softcap)


def value_and_grad(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
                   remat: bool = True, loss_chunk: int = 512):
    """-> (loss, grads): ``jax.value_and_grad`` of the loss, grads a tree
    like ``params`` in each leaf's dtype."""
    with torch.enable_grad():
        tracked = T.map(lambda p: p.detach().requires_grad_(), params)
        loss = _loss(tracked, cfg, batch, remat=remat, loss_chunk=loss_chunk)
        grads = torch.autograd.grad(loss, T.leaves(tracked))
    return loss.detach(), T.unflatten(params, list(grads))


def make_train_step(
    cfg: ModelConfig,
    optimizer: AdamW,
    schedule,
    *,
    microbatches: int = 1,
    remat: bool = True,
    loss_chunk: int = 512,
    max_grad_norm: float = 1.0,
    compression: bool = False,
):
    def compute_grads(params, batch):
        if microbatches == 1:
            return value_and_grad(params, cfg, batch, remat=remat, loss_chunk=loss_chunk)
        # split (B, ...) -> M x (B/M, ...) and accumulate fp32 grads over M
        mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])[i]
                for k, v in batch.items()} for i in range(microbatches)]
        loss_sum = dtm.lift(torch.zeros((), dtype=torch.float32,
                                        device=batch["labels"].device), batch["labels"])
        grads_sum = T.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        for mb in mbs:
            loss, grads = value_and_grad(params, cfg, mb, remat=remat, loss_chunk=loss_chunk)
            for a, g in zip(T.leaves(grads_sum), T.leaves(grads)):
                a.add_(g.float())
            loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / microbatches
        for g in T.leaves(grads_sum):
            g.mul_(inv)
        return loss_sum * inv, grads_sum

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, grads = compute_grads(state.params, batch)
        grads = T.map(reduce_like, grads, state.params)
        error_buf = state.error_buf
        if compression:
            grads, error_buf = compress_with_feedback(grads, error_buf)
        grads, grad_norm = clip_by_global_norm(grads, max_grad_norm)
        lr = schedule(state.step)
        new_params, new_opt = optimizer.update(grads, state.opt_state, state.params, lr)
        metrics = {
            "loss": loss,
            "grad_norm": grad_norm,
            "lr": lr,
            "step": state.step.to(torch.float32),
        }
        return TrainState(new_params, new_opt, state.step + 1, error_buf), metrics

    return train_step


def reduce_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its param: the partial sums of a
    param replicated over the data axes are all-reduced here, before
    compression, clipping and AdamW, as GSPMD reduces them. A plain
    gradient is returned as it is."""
    if dtm.is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_eval_step(cfg: ModelConfig, *, loss_chunk: int = 512):
    @torch.no_grad()
    def eval_step(params, batch):
        return _loss(params, cfg, batch, remat=False, loss_chunk=loss_chunk)
    return eval_step
