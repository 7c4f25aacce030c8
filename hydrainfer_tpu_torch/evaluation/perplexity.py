"""Perplexity through the paged-cache model (port of evaluation/perplexity.py).

Token-level negative log-likelihood of sequences, from one prefill a
sequence whose batch samples every position's logits, so that bf16, f32,
int8 / int4 / fp8 weights and the int8 KV cache can be compared with each
other and with HF transformers on the same checkpoint. On the card the
prefill runs the port's kernels (K2 or K6 attention, K3 cache writes, K4
for quantized projections).

Usage:
  python -m hydrainfer_tpu_torch.evaluation.perplexity --model-path CKPT
      [--quant int8] [--kv-int8] [--num-seqs 8] [--seq-len 128] [--device cpu]
"""
import argparse
import json
import math

import numpy as np
import torch

from ..models.factory import (TORCH_DTYPES, LanguageModelBatch, ModelFactoryConfig,
                              getModelFactory)
from ..ops.attention import PagedAttentionParams


def make_full_logit_batch(token_ids, block_size: int, hidden: int,
                          device=None) -> LanguageModelBatch:
    """A one-sequence batch whose every position is sampled, so the model
    returns every position's logits. The field layout is the JAX script's:
    the attention geometry padded to T sequences (kv_lens T, cu_q_lens
    [0, T, ..., T], num_seqs 1), blocks 0.. in order, and every sampled
    token bound for the discard slot."""
    T = len(token_ids)
    n_blocks = -(-T // block_size)
    i32 = dict(dtype=torch.int32, device=device)
    ar = torch.arange(T, **i32)
    return LanguageModelBatch(
        token_ids=torch.as_tensor(token_ids, **i32),
        positions=ar,
        attention=PagedAttentionParams(
            q_seq_ids=torch.zeros(T, **i32),
            q_local_ids=ar,
            positions=ar,
            kv_lens=torch.full((T,), T, **i32),
            block_tables=torch.arange(n_blocks, **i32).expand(T, n_blocks).contiguous(),
            new_kv_slot_ids=ar,
            cu_q_lens=torch.cat([torch.zeros(1, **i32), torch.full((T,), T, **i32)]),
            num_seqs=torch.ones(1, **i32)),
        sample_token_idx=ar,
        token_src_slots=torch.full((T,), -1, **i32),
        sample_dst_slots=torch.full((T,), -1, **i32),
        image_features=torch.zeros((0, hidden), dtype=torch.float32, device=device),
        image_dst_idx=torch.zeros(0, **i32))


def scratch_cache(lcfg, T: int, block_size: int, dtype, device) -> torch.Tensor:
    """A zeroed cache for one T-token sequence (one spare block), shaped from
    the model's config: (L, 1, blocks, block_size, planes, head_dim), planes
    2 x kv heads, or 1 for an MLA model's single-plane latent cache."""
    planes = 1 if lcfg.kv_single_plane else 2 * lcfg.n_kv_heads
    n_blocks = -(-T // block_size) + 1
    return torch.zeros((lcfg.n_layers, 1, n_blocks, block_size, planes, lcfg.head_dim),
                       dtype=dtype, device=device)


def all_logits(lm, lcfg, token_ids, block_size: int = 16,
               cache_dtype=torch.bfloat16) -> torch.Tensor:
    """(T, vocab) f32 logits at every position of one prefill on a scratch
    cache on the model's device."""
    device = lm.device
    cache = scratch_cache(lcfg, len(token_ids), block_size, cache_dtype, device)
    batch = make_full_logit_batch(token_ids, block_size, lcfg.hidden_size, device)
    with torch.no_grad():
        _, _, logits = lm.forward_with_logits(cache, batch, max_q=len(token_ids))
    return logits.float()


def _logsumexp(x):
    m = x.max(-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(-1, keepdims=True))


def sequence_nll(lm, lcfg, token_ids, block_size: int = 16,
                 cache_dtype=torch.bfloat16) -> float:
    """Mean NLL of token_ids[1:] given the prefix, via one prefill."""
    T = len(token_ids)
    logits = all_logits(lm, lcfg, token_ids, block_size, cache_dtype).cpu().numpy()
    logp = logits - _logsumexp(logits)
    targets = np.asarray(token_ids[1:])
    return float(-logp[np.arange(T - 1), targets].mean())


def evaluate(model_path: str, dtype: str = "bf16", quant: str = "none",
             kv_int8: bool = False, num_seqs: int = 8, seq_len: int = 128, seed: int = 0,
             device=None) -> dict:
    """Mean NLL and perplexity over num_seqs uniform random sequences (numpy,
    seeded: the JAX script's sequences) of the checkpoint at `model_path`."""
    factory = getModelFactory(ModelFactoryConfig(
        path=model_path, dtype=dtype, quantization=quant,
        kv_cache_dtype="int8" if kv_int8 else "auto"), device=device)
    lm = factory.getLanguageModel()
    lcfg = factory.getLanguageModelConfig()
    rng = np.random.default_rng(seed)
    cache_dtype = torch.int8 if kv_int8 else TORCH_DTYPES[dtype]
    nlls = []
    for _ in range(num_seqs):
        seq = rng.integers(0, lcfg.vocab_size, size=seq_len).tolist()
        nlls.append(sequence_nll(lm, lcfg, seq, cache_dtype=cache_dtype))
    nll = float(np.mean(nlls))
    return {"nll": nll, "perplexity": math.exp(nll), "num_seqs": num_seqs,
            "seq_len": seq_len, "dtype": dtype, "quant": quant, "kv_int8": kv_int8}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--num-seqs", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    print(json.dumps(evaluate(args.model_path, args.dtype, args.quant, args.kv_int8,
                              args.num_seqs, args.seq_len, device=args.device)))


if __name__ == "__main__":
    main()
