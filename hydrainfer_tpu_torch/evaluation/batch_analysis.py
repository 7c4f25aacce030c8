"""Batch-size analysis and analytic roofline latency model (port of
evaluation/batch_analysis.py).

Replaces the reference's evaluation/batch_analysis/batch_analysis.py:19-155
(step latency and throughput against batch size) and
evaluation/latency_model/compute_intensity.py (the bytes / FLOPs roofline
model) for one H100. The measured sweep runs the real engine (scheduler,
executor, decode graphs) through `ab_bench.build_engine`; the analytic
model predicts the HBM-bound decode step time from the architecture, which
gives the measured-against-roofline gap for each batch size.

Usage (card): python -m hydrainfer_tpu_torch.evaluation.batch_analysis --batches 1 8 32 64
      (CPU):  python -m hydrainfer_tpu_torch.evaluation.batch_analysis --tiny --arch tiny-lm --device cpu
"""
import argparse
import json
import time

import numpy as np

from .model_params import H100_HBM_BW, device_label

H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak, H100 SXM


def analytic_decode_model(cfg, batch: int, kv_len: int, weight_bytes: int,
                          kv_dtype_bytes: int = 2,
                          hbm_bytes_per_s: float = H100_HBM_BW,
                          peak_flops: float = H100_BF16_FLOPS):
    """HBM roofline for one decode step: every weight byte is read once per
    step (batch-shared), each sequence reads its own KV prefix. FLOPs =
    2 * params * batch (matmuls) — compute intensity tells which bound wins
    (reference: evaluation/latency_model/compute_intensity.py)."""
    kv_bytes_per_seq = (cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim
                        * kv_len * kv_dtype_bytes)
    bytes_total = weight_bytes + batch * kv_bytes_per_seq
    params = weight_bytes / 2  # bf16
    flops = 2 * params * batch
    t_mem = bytes_total / hbm_bytes_per_s
    t_compute = flops / peak_flops
    return {
        "t_mem_ms": round(t_mem * 1e3, 3),
        "t_compute_ms": round(t_compute * 1e3, 3),
        "bound": "memory" if t_mem > t_compute else "compute",
        "compute_intensity": round(flops / bytes_total, 1),
        "roofline_step_ms": round(max(t_mem, t_compute) * 1e3, 3),
        "roofline_tokens_per_s": round(batch / max(t_mem, t_compute), 1),
    }


def weight_bytes(cfg) -> int:
    """The language model's bf16 weight bytes from the architecture (2 bytes
    a parameter), without building the model."""
    per_layer = (cfg.hidden_size * (cfg.n_qo_heads + 2 * cfg.n_kv_heads)
                 * cfg.head_dim                        # qkv
                 + cfg.n_qo_heads * cfg.head_dim * cfg.hidden_size   # o
                 + 3 * cfg.hidden_size * cfg.intermediate_size)      # mlp
    embed = cfg.vocab_size * cfg.hidden_size
    params = cfg.n_layers * per_layer + embed * (1 if cfg.tie_word_embeddings
                                                 else 2)
    return 2 * params


def measured_sweep(arch: str, batches, prompt_len: int, gen: int, device=None):
    """Each batch as the root bench.py's run_bench measures it: bf16 weights
    and KV, block 16, token budget max(2048, 2 x prompt), boot warm-up, the
    node's default decode window; a warm-up round, then two timed rounds, of
    which the second is reported. The batches' engines share one weight
    factory."""
    from ..cluster.node import NodeConfig
    from ..models.random_init import RandomWeightFactory
    from . import ab_bench
    factory = RandomWeightFactory(arch, device=device)
    v = {**ab_bench.DEFAULTS, "label": "bf16",
         "multi_step": NodeConfig.multi_step_decode}
    rows = []
    for b in batches:
        engine = ab_bench.build_engine(arch, v, b, prompt_len, gen,
                                       max(2048, prompt_len * 2), device, factory=factory)
        engine.generate(ab_bench.make_requests(b, prompt_len, gen, "warm"), timeout_s=1200)
        for rnd in range(2):
            reqs = ab_bench.make_requests(b, prompt_len, gen, f"bench{rnd}")
            t0 = time.perf_counter()
            outs = engine.generate(reqs, timeout_s=1200)
            elapsed = time.perf_counter() - t0
        total = sum(len(o.output_token_ids) for o in outs)
        assert total == b * gen, f"batch {b}: {total} of {b * gen} tokens"
        tput = total / elapsed
        # the decode roofline as run_bench states it: b tokens per read of
        # the bf16 weights at the card's HBM rate
        roofline = b / (factory.param_count() * 2 / H100_HBM_BW)
        # a request's mean inter-token time (robust to tokens read a window
        # at a time)
        tbts = [(o.token_times[-1] - o.token_times[0]) / (len(o.token_times) - 1)
                for o in outs if len(o.token_times) > 1]
        rows.append({"batch": b, "tokens_per_s": round(tput, 2),
                     "vs_roofline": round(tput / roofline, 4),
                     "p50_tbt_s": round(float(np.median(tbts)), 5) if tbts else None})
    return rows


def markdown(arch: str, batches, prompt_len: int, gen: int, analytic: dict,
             rows=None) -> str:
    """The JAX script's table: each batch's analytic row, beside its
    measured row where `rows` is given."""
    lines = [f"# Batch analysis — {arch} (prompt {prompt_len}, gen {gen})\n",
             "| batch | roofline tok/s | bound | intensity (flops/B) |"
             + (" measured tok/s | vs roofline | p50 tbt |" if rows else ""),
             "|---|---|---|---|" + ("---|---|---|" if rows else "")]
    for i, b in enumerate(batches):
        a = analytic[b]
        line = (f"| {b} | {a['roofline_tokens_per_s']} | {a['bound']} "
                f"| {a['compute_intensity']} |")
        if rows:
            m = rows[i]
            line += (f" {m['tokens_per_s']} | {m['vs_roofline']} "
                     f"| {m['p50_tbt_s']}s |")
        lines.append(line)
    lines.append("\nDecode stays memory-bound until compute intensity reaches "
                 f"~{int(H100_BF16_FLOPS / H100_HBM_BW)} flops/byte (the H100 SXM's "
                 "ridge point: 989 TFLOP/s of dense bf16 over 3.35 TB/s of HBM3) "
                 "— batching decode is free throughput until then, which is why "
                 "the decode node wants the biggest batch the KV pool allows "
                 "(reference: evaluation/batch_analysis).")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-2b-lm")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32, 64])
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--model-only", action="store_true",
                    help="print only the analytic model (no engine runs)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.tiny:
        args.batches, args.prompt_len, args.gen = [1, 4], 16, 8

    from ..models.random_init import ARCH_CONFIGS
    cfg = ARCH_CONFIGS[args.arch]
    wbytes = weight_bytes(cfg)

    rows = None
    if not args.model_only:
        rows = measured_sweep(args.arch, args.batches, args.prompt_len,
                              args.gen, args.device)
    analytic = {}
    for b in args.batches:
        analytic[b] = analytic_decode_model(
            cfg, b, args.prompt_len + args.gen // 2, wbytes)
    print(markdown(args.arch, args.batches, args.prompt_len, args.gen, analytic, rows))
    if rows:
        print(f"\nmeasured on: {device_label(args.device)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "analytic": analytic,
                       "measured": rows}, f, indent=1)


if __name__ == "__main__":
    main()
