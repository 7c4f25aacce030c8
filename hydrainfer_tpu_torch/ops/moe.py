"""Mixture-of-Experts ops (port of hydrainfer_tpu/ops/moe.py): routing and
the sort-based grouped expert FFN.

Routing is plain tensor code: greedy top-k over softmax or sigmoid scores
(`route`), and group-limited routing (`grouped_topk`: DeepSeek-V3's noaux_tc
and DeepSeek-V2's group_limited_greedy). The dispatch sorts the T * k
(token, expert) pairs by expert and runs ONE grouped product a projection,
`torch._grouped_mm` over the experts' contiguous row groups: the counterpart
of the JAX package's `jax.lax.ragged_dot`, which is not a Pallas kernel
either (so there is no TPU kernel to port here). Every shape is static (n =
T * k rows whatever the routing), and nothing is read on the host: group
sizes are counted with `index_add_` (torch.bincount reads its maximum on the
host), offsets are an int32 cumsum, the sort is a stable argsort. So a bf16
dispatch on the card captures in a CUDA graph. The weighted rows go back to
their (token, choice) places with `index_copy_`, and each token sums its k
rows in f32 in a fixed order: a scatter-add (JAX's `.at[].add`) would sum
them by float atomics on the card, in an order that changes from run to
run, and a graph replay could then part from the eager step at a near tie.

On the card torch._grouped_mm runs bf16 only on its fast path; its f32 form
loops over the groups with their sizes read on the host, so an f32 MoE
model on the card runs without CUDA graphs, and a capture of it raises
(`grouped_mm`). torch._grouped_mm wants every row stride a multiple of 16
bytes (d and the expert width a multiple of 8 in bf16). `grouped_mm` counts
its calls on the card in `launches`, as the kernel wrappers do (it is in
ops/cuda's WRAPPERS, so graph replays add theirs).

Expert parallelism (`moe_ffn_ep`, the JAX `moe_ffn_ep`): each rank holds a
contiguous run of E/tp experts and runs `moe_ffn` on the routing masked to
them; the ranks' partial outputs are summed in rank
order (parallel/mesh.py:RankGroup.all_reduce), never by atomics.
"""
from typing import Optional, Sequence, Tuple

import torch

from .activation import silu_and_mul


def topk_softmax(router_logits: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (weights (T, k) normalized, expert ids (T, k)):
    Mixtral routing."""
    return route(router_logits, top_k, scoring="softmax", norm_topk=True)


def route_scores(logits: torch.Tensor, scoring: str) -> torch.Tensor:
    """f32 softmax or sigmoid scores of router logits."""
    logits = logits.float()
    return torch.softmax(logits, dim=-1) if scoring == "softmax" else torch.sigmoid(logits)


def route(router_logits: torch.Tensor, top_k: int, scoring: str = "softmax",
          norm_topk: bool = True, routed_scaling: float = 1.0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy top-k routing with softmax or sigmoid scoring."""
    weights, idx = torch.topk(route_scores(router_logits, scoring), top_k, dim=-1)
    if norm_topk and top_k > 1:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * routed_scaling, idx.to(torch.int32)


def grouped_topk(scores_logits: torch.Tensor, bias: Optional[torch.Tensor],
                 n_groups: int, topk_groups: int, top_k: int, scoring: str = "sigmoid",
                 group_agg: str = "top2sum", norm_topk: bool = True,
                 routed_scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-limited routing: keep the topk_groups best expert groups (by the
    max or the top-2 sum of scores + bias), then the top-k experts inside
    them; the weights are the unbiased scores, optionally normalized, then
    scaled."""
    T, E = scores_logits.shape
    scores = route_scores(scores_logits, scoring)
    biased = scores if bias is None else scores + bias.float()[None, :]
    grouped = biased.reshape(T, n_groups, E // n_groups)
    if group_agg == "max":
        group_score = grouped.amax(dim=-1)
    else:
        group_score = torch.topk(grouped, 2, dim=-1)[0].sum(dim=-1)
    keep = torch.topk(group_score, topk_groups, dim=-1)[1]
    group_mask = torch.zeros((T, n_groups), dtype=torch.bool,
                             device=scores.device).scatter_(1, keep, True)
    expert_mask = group_mask[:, :, None].expand(T, n_groups, E // n_groups).reshape(T, E)
    masked = torch.where(expert_mask, biased, float("-inf"))
    idx = torch.topk(masked, top_k, dim=-1)[1]
    weights = scores.gather(1, idx)
    if norm_topk:
        weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-20)
    return weights * routed_scaling, idx.to(torch.int32)


def grouped_topk_sigmoid(scores_logits: torch.Tensor, bias: torch.Tensor, n_groups: int,
                         topk_groups: int, top_k: int, routed_scaling: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's noaux_tc gate: sigmoid + correction bias, groups by
    their top-2 sum, normalized weights."""
    return grouped_topk(scores_logits, bias, n_groups, topk_groups, top_k,
                        scoring="sigmoid", group_agg="top2sum", norm_topk=True,
                        routed_scaling=routed_scaling)


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(n, K) rows grouped by `offs` (int32 end offsets) times (E, K, N): the
    dispatch's grouped product (torch._grouped_mm)."""
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError(f"torch {torch.__version__} has no torch._grouped_mm: the MoE "
                           "grouped product needs it")
    if (a.is_cuda and a.dtype != torch.bfloat16
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("torch._grouped_mm reads the group sizes on the host outside "
                           "bf16: serve a non-bf16 MoE model with cuda_graphs off")
    if a.is_cuda:
        grouped_mm.launches += 1
    return torch._grouped_mm(a, b, offs=offs)


grouped_mm.launches = 0


def dispatch_offsets(expert_ids: torch.Tensor, n_experts: int):
    """The dispatch's grouping of the flattened (token, choice) pairs: their
    order sorted by expert (stable: token order kept within an expert) and
    each expert's int32 end offset in it, all on the device."""
    flat = expert_ids.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=flat.device).index_add_(
        0, flat, torch.ones(flat.numel(), dtype=torch.int32, device=flat.device))
    return order, torch.cumsum(sizes, 0, dtype=torch.int32)


def moe_ffn(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
            weights: torch.Tensor, expert_ids: torch.Tensor) -> torch.Tensor:
    """Grouped-product expert FFN. x: (T, d); gate_up: (E, d, 2I); down: (E,
    I, d); weights / expert_ids: (T, k) from a routing function. Returns (T,
    d) in x's dtype. Each product accumulates in f32 and rounds to x's dtype
    (the JAX down product stays f32 until the weighting: in bf16 the two
    differ by that rounding); an expert that no row picked is a group of
    size 0 and gives nothing."""
    T, d = x.shape
    E, k = gate_up.shape[0], expert_ids.shape[1]
    n = T * k
    order, offs = dispatch_offsets(expert_ids, E)
    sorted_tokens = (torch.arange(n, device=x.device) // k)[order]
    sorted_weights = weights.reshape(n)[order].float()
    h = silu_and_mul(grouped_mm(x[sorted_tokens], gate_up, offs))
    out = grouped_mm(h, down, offs).float() * sorted_weights[:, None]
    # back to (token, choice) order, then each token's k rows summed
    unsorted = torch.empty_like(out).index_copy_(0, order, out)
    return unsorted.view(T, k, d).sum(dim=1).to(x.dtype)


def moe_ffn_ep(x: torch.Tensor, gate_ups: Sequence[torch.Tensor],
               downs: Sequence[torch.Tensor], weights: torch.Tensor,
               expert_ids: torch.Tensor, group,
               extra: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Expert-parallel FFN: rank r holds gate_ups[r] / downs[r], its
    contiguous run of the experts, on group.devices[r]; the tokens and the
    routing are replicated (copied to each rank's device). A (token, expert)
    pair of another rank goes to local expert 0 with weight 0, so every
    rank's dispatch keeps the unsharded shapes. extra[r], if given, joins
    rank r's partial before the one sum (a MoE layer's shared experts,
    models/decoder.py:_layer_mlp). Returns the ranks' partials summed in
    rank order on rank 0's device."""
    parts, first = [], 0
    for r, (gu, dn, dev) in enumerate(zip(gate_ups, downs, group.devices)):
        ids = expert_ids.to(dev)
        local = (ids >= first) & (ids < first + gu.shape[0])
        part = moe_ffn(x.to(dev), gu, dn, torch.where(local, weights.to(dev), 0.0),
                       torch.where(local, ids - first, 0))
        parts.append(part if extra is None else part + extra[r])
        first += gu.shape[0]
    return group.all_reduce(parts)


def moe_ffn_dense(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                  weights: torch.Tensor, expert_ids: torch.Tensor) -> torch.Tensor:
    """The plain version: every expert on every token in f32, combined by the
    routing weights. O(T * E)."""
    E = gate_up.shape[0]
    h = torch.einsum("td,edi->tei", x.float(), gate_up.float())
    h = torch.nn.functional.silu(h[..., :h.shape[-1] // 2]) * h[..., h.shape[-1] // 2:]
    y = torch.einsum("tei,eid->ted", h, down.float())
    mask = torch.zeros((x.shape[0], E), dtype=torch.float32, device=x.device)
    mask.scatter_add_(1, expert_ids.long(), weights.float())
    return torch.einsum("ted,te->td", y, mask).to(x.dtype)
