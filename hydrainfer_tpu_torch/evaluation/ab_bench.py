"""Interleaved in-process A/B of engine variants (port of evaluation/ab_bench.py).

Throughput of one configuration moves between processes and between minutes
(the host's load, the card's clocks under its power limit). Within one
process the drift is shared, so this harness builds every variant's engine
side by side, warms each, and interleaves the measured rounds in alternating
order (A, B / B, A / ...); it reports each variant's per-round ratio to the
first variant, paired round by round, so drift cancels in the pair and a
slope cancels in the alternation.

Usage (card):
  python -m hydrainfer_tpu_torch.evaluation.ab_bench --arch llava-7b-lm --rounds 4 \\
      "int8;quant=int8;kv_int8=1" "fp8;quant=fp8;kv_int8=1"
  (CPU: add --device cpu and a small --arch, e.g. tiny-lm.)

Each variant is "label;key=value;...", with the keys quant (none | int8 |
int4 | fp8), kv_int8, kv_blocks (0 = sized from the traffic), multi_step
(the fused decode window), block_size, depth (async_pipeline_depth) and
post_k (postprocess_batch_steps). The JAX harness's layer_loop, kv_ref,
pipeline, kv_pages_per_block, pallas_qmm, attn_impl and bisect keys select
TPU machinery that the port does not have, and are refused by name.
"""
import argparse
import json
import statistics
import string
import time
import zlib

import numpy as np

# the JAX harness's keys that select TPU machinery (ROADMAP.md, "TPU-only
# machinery is not ported"), each with what it selects there
TPU_ONLY_KEYS = {
    "layer_loop": "the scan / unroll layer loops",
    "kv_ref": "the jax.Ref cache",
    "pipeline": "the tunnel-tuned pipeline_mode variants",
    "kv_pages_per_block": "the Pallas kernel's pages per block",
    "pallas_qmm": "the choice between the Pallas and the XLA int8 matmul (the port "
                  "runs K4 on every quantized projection on the card)",
    "attn_impl": "the JAX attention implementations (the port has one per step form)",
    "bisect": "the JAX layer bisection switches",
}
DEFAULTS = {"quant": "none", "kv_int8": False, "kv_blocks": 0, "multi_step": 1,
            "block_size": 16, "depth": 2, "post_k": 4}


def parse_variant(spec: str) -> dict:
    parts = spec.split(";")
    v = {"label": parts[0], **DEFAULTS}
    for p in parts[1:]:
        k, _, val = p.partition("=")
        if k in TPU_ONLY_KEYS:
            raise ValueError(f"variant key {k!r} selects {TPU_ONLY_KEYS[k]}: TPU-only "
                             "machinery the port does not have (ROADMAP.md, "
                             "\"TPU-only machinery is not ported\")")
        assert k in v and k != "label", f"unknown variant key {k}"
        v[k] = (val.lower() in ("1", "true") if isinstance(v[k], bool)
                else type(v[k])(val))
    return v


def build_engine(arch, v, n_requests, prompt_len, max_tokens, token_budget, device=None):
    from ..cluster.node import NodeConfig
    from ..engine.profiler import BatchSchedulerProfilerConfig
    from ..engine.request_processor import RequestProcessorConfig
    from ..engine.scheduler import BatchSchedulerConfig
    from ..entrypoint.offline import OfflineEngine
    from ..models.random_init import RandomWeightFactory
    factory = RandomWeightFactory(arch, quantization=v["quant"],
                                  kv_scale=0.05 if v["kv_int8"] else None, device=device)
    bs = v["block_size"]
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=n_requests,
                                             priority="prefill"),
        request_processor=RequestProcessorConfig(num_request_process_workers=1),
        profiler=BatchSchedulerProfilerConfig(enabled=False,
                                              default_token_budget=token_budget),
        kv_block_size=bs,
        n_kv_blocks=v["kv_blocks"] or max(256 * 16 // bs,
                                          2 * n_requests * (prompt_len + max_tokens) // bs),
        n_image_blocks=1, multi_step_decode=v["multi_step"],
        async_pipeline_depth=v["depth"], postprocess_batch_steps=v["post_k"],
        # the key floors raised and the decode keys met at boot: round 0 meets
        # no new key
        boot_warmup=True)
    return OfflineEngine(cfg, model_factory=factory, node_type="PD", device=device)


def make_requests(n, prompt_len, max_tokens, tag):
    from ..request import Request, SamplingParameters
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return [Request(request_id=f"{tag}{i}",
                    prompt="".join(rng.choice(list(string.ascii_lowercase + " "),
                                              size=prompt_len)),
                    sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                       ignore_eos=True))
            for i in range(n)]


def paired_report(arch, rounds, n_requests, variants, tputs) -> dict:
    """Each variant's median tokens/s and its per-round ratios to the first
    variant's: their geometric mean and their range."""
    base = variants[0]["label"]
    report = {"arch": arch, "rounds": rounds, "n_requests": n_requests, "variants": {}}
    for v in variants:
        ts = tputs[v["label"]]
        ratios = [t / b for t, b in zip(ts, tputs[base])]
        report["variants"][v["label"]] = {
            "median_tokens_per_s": round(statistics.median(ts), 1),
            "paired_ratio_vs_" + base: round(statistics.geometric_mean(ratios), 4),
            "ratio_spread": [round(min(ratios), 3), round(max(ratios), 3)],
        }
    return report


def run_ab(arch, specs, rounds=4, n_requests=32, prompt_len=128, max_tokens=128,
           token_budget=2048, device=None, log=print, keep=None) -> dict:
    """Build and warm each variant's engine, then run `rounds` interleaved
    measured rounds; every request of every round must finish with
    max_tokens tokens. keep: a list that receives the engines."""
    variants = [parse_variant(s) for s in specs]
    engines = []
    for v in variants:
        engines.append(build_engine(arch, v, n_requests, prompt_len, max_tokens,
                                    token_budget, device))
        # every shape this variant meets, before any timed round
        engines[-1].generate(make_requests(n_requests, prompt_len, max_tokens,
                                           f"w{v['label']}"), timeout_s=1800)
        log(f"# warmed {v['label']}")
    tputs = {v["label"]: [] for v in variants}
    order = list(range(len(variants)))
    for r in range(rounds):
        for i in (order if r % 2 == 0 else order[::-1]):
            v = variants[i]
            reqs = make_requests(n_requests, prompt_len, max_tokens, f"r{r}v{i}")
            t0 = time.perf_counter()
            outs = engines[i].generate(reqs, timeout_s=1800)
            dt = time.perf_counter() - t0
            total = sum(len(o.output_token_ids) for o in outs)
            assert total == n_requests * max_tokens, (
                f"{v['label']} round {r}: {total} of {n_requests * max_tokens} tokens")
            tputs[v["label"]].append(total / dt)
        log(f"# round {r}: "
            + json.dumps({v["label"]: round(tputs[v["label"]][-1], 1) for v in variants}))
    if keep is not None:
        keep.extend(engines)
    return paired_report(arch, rounds, n_requests, variants, tputs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", help='"label;key=value;..."')
    ap.add_argument("--arch", default="qwen2-vl-2b-lm")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--n-requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=128)
    ap.add_argument("--token-budget", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    report = run_ab(args.arch, args.variants, args.rounds, args.n_requests, args.prompt_len,
                    args.max_tokens, args.token_budget, args.device,
                    log=lambda s: print(s, flush=True))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
