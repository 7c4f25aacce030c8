"""The quantization-quality table (port of evaluation/quant_quality.py).

For each quantization config (int8 / int4 / fp8 weights, the int8 KV cache,
and int8 weights with the int8 KV cache) it measures, against the bf16 run
of the SAME checkpoint on the SAME token sequences:

  - delta NLL / delta perplexity (drift of the distribution);
  - top-1 agreement (the share of positions whose greedy token matches);
  - mean KL(bf16 || quant) in nats.

The checkpoints are HF `save_pretrained` trees built here from fixed seeds (no
download): a Llama decoder and a DeepSeek-V3 MLA decoder (q-LoRA, 8 routed
experts, top-2), whose single-plane latent cache takes the int8 KV path. Each
is trained briefly (HF transformers, on the chosen device) on a sparse
synthetic Markov task and evaluated on held-out sequences of the same chain:
a trained model has real logit margins, so top-1 agreement measures greedy
decode invariance, where on an untrained init it is noise.

All-position logits come from one prefill a sequence through the port's
paged-cache model: on the card through its kernels (K2 or K6, K3, and K4's
int8, int4 or fp8 form).

Usage:
  python -m hydrainfer_tpu_torch.evaluation.quant_quality [--device cpu]
      [--out quant_quality_torch.json] [--num-seqs 8] [--train-steps 400]
"""
import argparse
import json
import math
import os
import tempfile

import numpy as np
import torch

from ..models.factory import ModelFactoryConfig, getModelFactory
from ..utils.device import resolve_device
from .perplexity import all_logits

# (label, weight quantization, int8 KV)
CONFIGS = [
    ("bf16", "none", False),          # the baseline
    ("int8", "int8", False),
    ("int4", "int4", False),
    ("fp8", "fp8", False),
    ("int8kv", "none", True),
    ("int8+int8kv", "int8", True),
]


def make_llama_ckpt(root: str) -> str:
    import transformers
    path = os.path.join(root, "tiny_llama_q")
    cfg = transformers.LlamaConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=704,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval().to(torch.float32)
    model.save_pretrained(path, safe_serialization=True)
    return path


def make_mla_ckpt(root: str) -> str:
    import transformers
    path = os.path.join(root, "tiny_dsv3_q")
    cfg = transformers.DeepseekV3Config(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
        n_group=4, topk_group=2, routed_scaling_factor=1.5,
        norm_topk_prob=True, first_k_dense_replace=1,
        kv_lora_rank=16, q_lora_rank=24,
        qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
        max_position_embeddings=256, rope_interleave=True,
        attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(1)
    model = transformers.DeepseekV3ForCausalLM(cfg).eval().to(torch.float32)
    model.save_pretrained(path, safe_serialization=True)
    return path


def markov_sampler(vocab: int, branching: int = 4, seed: int = 7):
    """Sparse first-order Markov chain: every token has `branching` fixed
    successors with Zipf-like transition probabilities (entropy ~0.92 nats),
    so a trained model is confident. sample(n_seqs, T, seed2) -> (n_seqs, T)
    int64 (numpy: the JAX script's sequences for the same seeds)."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branching))
    probs = np.asarray([0.7, 0.15, 0.1, 0.05][:branching], np.float64)
    probs = probs / probs.sum()

    def sample(n_seqs: int, T: int, seed2: int) -> np.ndarray:
        r = np.random.default_rng(seed2)
        seqs = np.empty((n_seqs, T), np.int64)
        seqs[:, 0] = r.integers(0, vocab, n_seqs)
        for t in range(1, T):
            choice = r.choice(len(probs), size=n_seqs, p=probs)
            seqs[:, t] = succ[seqs[:, t - 1], choice]
        return seqs

    return sample


def train_ckpt(path: str, sampler, steps: int, batch: int = 16, T: int = 64,
               lr: float = 1e-3, device=None) -> float:
    """Train the HF checkpoint on the Markov task with Adam (HF transformers
    on `device`, the card by default, in f32); overwrites the checkpoint in
    place. Returns the final loss."""
    import transformers
    device = resolve_device(device)
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_pretrained(path).float().to(device)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    loss = float("nan")
    for step in range(steps):
        seqs = torch.from_numpy(sampler(batch, T, 10_000 + step)).to(device)
        out = model(input_ids=seqs, labels=seqs)
        out.loss.backward()
        opt.step()
        opt.zero_grad()
        loss = out.loss.item()
    model.eval().cpu().save_pretrained(path, safe_serialization=True)
    return loss


def all_position_logits(path: str, quant: str, kv_int8: bool, seqs: np.ndarray,
                        block_size: int = 16, device=None) -> np.ndarray:
    """(n_seqs, T, vocab) f32 logits at every position, one prefill a
    sequence through the port's paged-cache model in bf16 (its kernels on
    the card, their plain versions on the CPU)."""
    factory = getModelFactory(ModelFactoryConfig(
        path=path, dtype="bfloat16", quantization=quant,
        kv_cache_dtype="int8" if kv_int8 else "auto"), device=device)
    lm = factory.getLanguageModel()
    lcfg = factory.getLanguageModelConfig()
    cache_dtype = torch.int8 if kv_int8 else torch.bfloat16
    return np.stack([all_logits(lm, lcfg, [int(t) for t in seq], block_size,
                                cache_dtype).cpu().numpy() for seq in seqs])


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(-1, keepdims=True)
    z = x - m
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


def metrics_vs_baseline(logits: np.ndarray, base: np.ndarray, seqs: np.ndarray) -> dict:
    logp = _log_softmax(logits)
    base_logp = _log_softmax(base)
    # next-token NLL of the fixed sequences
    tgt = seqs[:, 1:]
    idx = np.arange(seqs.shape[1] - 1)
    nll = float(np.mean([-lp[idx, t].mean() for lp, t in zip(logp, tgt)]))
    base_nll = float(np.mean([-lp[idx, t].mean() for lp, t in zip(base_logp, tgt)]))
    agree = float((logits.argmax(-1) == base.argmax(-1)).mean())
    kl = float((np.exp(base_logp) * (base_logp - logp)).sum(-1).mean())
    return {"nll": round(nll, 5), "perplexity": round(math.exp(nll), 3),
            "delta_nll": round(nll - base_nll, 5),
            "delta_perplexity": round(math.exp(nll) - math.exp(base_nll), 3),
            "top1_agreement": round(agree, 4),
            "mean_kl_nats": round(kl, 6)}


def eval_sequences(n_seqs: int, seq_len: int, vocab: int, seed: int,
                   sampler=None) -> np.ndarray:
    """The held-out sequences of the trained task (seed 777 + seed), or
    uniform random tokens without a sampler."""
    if sampler is not None:
        return sampler(n_seqs, seq_len, 777 + seed)
    return np.random.default_rng(seed).integers(0, vocab, size=(n_seqs, seq_len))


def table(logits_by_config: dict, seqs: np.ndarray) -> dict:
    """{label: metrics_vs_baseline} against the first config's logits."""
    base = next(iter(logits_by_config.values()))
    return {label: metrics_vs_baseline(lg, base, seqs)
            for label, lg in logits_by_config.items()}


def evaluate_model(path: str, n_seqs: int, seq_len: int, vocab: int, seed: int,
                   sampler=None, device=None) -> dict:
    seqs = eval_sequences(n_seqs, seq_len, vocab, seed, sampler)
    return table({label: all_position_logits(path, quant, kv_int8, seqs, device=device)
                  for label, quant, kv_int8 in CONFIGS}, seqs)


def markdown(rows: dict) -> str:
    lines = ["| config | ppl | Δppl | top-1 agree | KL (nats) |", "|---|---|---|---|---|"]
    lines += [f"| {label} | {m['perplexity']} | {m['delta_perplexity']} "
              f"| {m['top1_agreement']} | {m['mean_kl_nats']} |" for label, m in rows.items()]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="quant_quality_torch.json")
    ap.add_argument("--num-seqs", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="",
                    help="reuse/keep checkpoints here (default: temp dir)")
    ap.add_argument("--train-steps", type=int, default=400,
                    help="training steps on the synthetic Markov task before "
                         "measuring (0 = evaluate the raw init)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    root = args.ckpt_dir or tempfile.mkdtemp(prefix="quantq_")
    results = {}
    llama = make_llama_ckpt(root)
    llama_sampler = None
    if args.train_steps:
        llama_sampler = markov_sampler(2048, seed=7)
        loss = train_ckpt(llama, llama_sampler, args.train_steps, device=args.device)
        print(f"llama-tiny trained {args.train_steps} steps, "
              f"final loss {loss:.3f} (task entropy ~0.92 nats)")
    results["llama-tiny"] = evaluate_model(llama, args.num_seqs, seq_len=128, vocab=2048,
                                           seed=0, sampler=llama_sampler,
                                           device=args.device)
    mla = make_mla_ckpt(root)
    mla_sampler = None
    if args.train_steps:
        mla_sampler = markov_sampler(256, seed=9)
        loss = train_ckpt(mla, mla_sampler, args.train_steps, T=48, device=args.device)
        print(f"deepseek-v3-mla-tiny trained {args.train_steps} steps, "
              f"final loss {loss:.3f}")
    results["deepseek-v3-mla-tiny"] = evaluate_model(
        mla, args.num_seqs, seq_len=64, vocab=256, seed=1, sampler=mla_sampler,
        device=args.device)

    payload = {
        "methodology": ("HF save_pretrained checkpoints (fixed torch seeds), trained on a "
                        "Markov task, held-out sequences, all-position logits through the "
                        "port's paged-cache model on " + args.device + "; every quant "
                        "config vs the bf16 run of the same checkpoint"),
        "configs": [c[0] for c in CONFIGS],
        "results": results,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    for model, rows in results.items():
        print(f"\n## {model}\n{markdown(rows)}")
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
