"""Speculative decoding A/B (port of evaluation/spec_bench.py): greedy
generation at a small batch over a repetitive (lookup-friendly) prompt,
n-gram speculation on against off, interleaved in one process. Reports
tokens/s of each and their ratio.

Usage (card): python -m hydrainfer_tpu_torch.evaluation.spec_bench --arch llava-7b-lm
      (CPU):  python -m hydrainfer_tpu_torch.evaluation.spec_bench --tiny --device cpu
"""
import argparse
import json
import time

# a summary- or copy-shaped prompt: its n-grams recur, so lookups find drafts
PROMPT = ("the quarterly report shows revenue of the quarterly report "
          "shows revenue of the division and the quarterly report ") * 3


def build_engine(arch, spec_k, n_ctx, device=None, factory=None):
    """A PD engine of 8 at spec_ngram_k = spec_k (0 = off), on `factory` or
    on bf16 random weights at `arch`."""
    from ..cluster.node import NodeConfig
    from ..engine.request_processor import RequestProcessorConfig
    from ..engine.scheduler import BatchSchedulerConfig
    from ..entrypoint.offline import OfflineEngine
    from ..models.random_init import RandomWeightFactory
    if factory is None:
        factory = RandomWeightFactory(arch, device=device)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=8, priority="prefill"),
        request_processor=RequestProcessorConfig(num_request_process_workers=1),
        kv_block_size=16, n_kv_blocks=max(512, n_ctx // 4), n_image_blocks=1,
        spec_ngram_k=spec_k)
    return OfflineEngine(cfg, model_factory=factory, node_type="PD", device=device)


def make_requests(n, prompt, max_tokens, tag):
    from ..request import Request, SamplingParameters
    return [Request(request_id=f"{tag}{i}", prompt=prompt,
                    sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                       ignore_eos=True))
            for i in range(n)]


def bench(engine, n, prompt, max_tokens, tag):
    """A warm-up pass, then a timed one: (tokens/s, seconds, outputs)."""
    engine.generate(make_requests(n, prompt, max_tokens, tag + "w"), timeout_s=1200)
    t0 = time.perf_counter()
    outs = engine.generate(make_requests(n, prompt, max_tokens, tag), timeout_s=1200)
    dt = time.perf_counter() - t0
    return sum(len(o.output_token_ids) for o in outs) / dt, dt, outs


def run_spec_bench(arch, batch=2, max_tokens=96, spec_k=3, rounds=3, device=None,
                   factory=None, log=print, keep=None) -> dict:
    """`rounds` interleaved rounds of speculation off then on, on two
    engines over the same weights (`factory`, or one bf16 random factory);
    reports the round with the median ratio. keep: a dict that receives the
    engines ("base", "spec") and each round's outputs ("outs")."""
    from ..models.random_init import RandomWeightFactory
    if factory is None:
        factory = RandomWeightFactory(arch, device=device)
    n_ctx = len(PROMPT) + max_tokens
    base = build_engine(arch, 0, n_ctx, device, factory)
    spec = build_engine(arch, spec_k, n_ctx, device, factory)
    rows, outs = [], []
    for r in range(rounds):
        t_base, _, o_base = bench(base, batch, PROMPT, max_tokens, f"b{r}")
        t_spec, _, o_spec = bench(spec, batch, PROMPT, max_tokens, f"s{r}")
        rows.append((t_base, t_spec))
        outs.append((o_base, o_spec))
        log(f"# round {r}: base {t_base:.1f} tok/s, spec {t_spec:.1f} tok/s "
            f"({t_spec / t_base:.2f}x)")
    med = sorted(rows, key=lambda x: x[1] / x[0])[len(rows) // 2]
    if keep is not None:
        keep.update(base=base, spec=spec, outs=outs)
    return {"arch": arch, "batch": batch, "spec_k": spec_k,
            "base_tokens_per_s": round(med[0], 1), "spec_tokens_per_s": round(med[1], 1),
            "speedup": round(med[1] / med[0], 3),
            "spec_steps": spec.node.fill_executor.spec_steps,
            "spec_tokens": spec.node.fill_executor.spec_tokens}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-2b-lm")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-tokens", type=int, default=96)
    ap.add_argument("--spec-k", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.tiny:
        args.arch, args.max_tokens, args.rounds = "tiny-lm", 24, 2
    print(json.dumps(run_spec_bench(args.arch, args.batch, args.max_tokens, args.spec_k,
                                    args.rounds, args.device)))


if __name__ == "__main__":
    main()
