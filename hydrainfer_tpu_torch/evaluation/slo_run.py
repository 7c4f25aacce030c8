"""End-to-end SLO-attainment run on one card (port of evaluation/slo_run.py):
boot the API server over a random-weight engine, sweep Poisson request rates
with the repo's `benchmark` client, and print the goodput / attainment table
(reference: evaluation/slo_attainment/evaluation.sh:5-47 — server up, rate
sweep, performance_analyzer).

Usage (card):  python -m hydrainfer_tpu_torch.evaluation.slo_run --rates 2 4 8 16 --out result/slo
        (CPU): python -m hydrainfer_tpu_torch.evaluation.slo_run --tiny --arch tiny-lm --device cpu

The client (`benchmark/`, an OpenAI-protocol HTTP client), the aiohttp
server and the node's serving loop share one asyncio event loop, so the
client's timestamps include the loop's contention. Run from the repo root:
`benchmark` is the root package. `rate_<r>.json` and `summary.json` keep the
JAX driver's schema; `summary.json` adds `device`, the card's name and power
limit as nvidia-smi gives them (or "cpu").
"""
import argparse
import asyncio
import json
import os

from .model_params import device_label


def node_config(args, factory):
    """The node of the JAX driver, less its TPU-only prefill jit-key ladder."""
    from ..cluster.node import NodeConfig
    from ..engine.scheduler import BatchSchedulerConfig
    node = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(
            max_running_requests=args.max_batch, priority="prefill"),
        kv_block_size=16,
        # NOTE an oversized pool raises the boot fair-share context (blocks x
        # block size / max batch, capped at boot_warmup_max_context) and with
        # it the block-table floor MB: every step's page table is MB wide, K1
        # and K2 walk it (K1's split-KV count follows MB x block size), and
        # each MB is a graph key of its own. --kv-blocks pins the pool to the
        # workload envelope instead.
        n_kv_blocks=args.kv_blocks or max(
            2048, 4 * args.max_batch *
            (args.max_prompt_len + args.max_output_len) // 16),
        n_image_blocks=(max(8, args.max_batch) if args.image_ratio > 0 else 1),
        image_block_size=(factory.clip_cfg.n_patches
                          if args.image_ratio > 0 else -1))
    node.model.dtype = "bf16"
    if args.kv_int8:
        node.model.kv_cache_dtype = "int8"
    if args.multi_step:
        node.multi_step_decode = args.multi_step
    # converge the key floors at boot (S = max batch, MB from the pool) and
    # capture the decode graphs met there. A decode key that neither boot
    # nor the warm-up passes meet (a small batch, T, in the Poisson tail)
    # is still captured inside the timed sweep; `amain`'s sweep_metrics
    # shows it
    node.boot_warmup = True
    return node


def make_entries(args):
    from benchmark.synthetic_dataset import load_entries_json, make_synthetic_entries
    if args.entries:
        # dataset entries produced by benchmark.data_preprocess (the
        # reference benchmarks lmms-lab dumps this way,
        # reference: benchmark/synthetic_dataset.py:42-48)
        return load_entries_json(args.entries)[: args.num_requests]
    return make_synthetic_entries(
        args.num_requests, image_ratio=args.image_ratio,
        prompt_len_range=(args.min_prompt_len, args.max_prompt_len),
        output_len_range=(args.min_output_len, args.max_output_len),
        seed=0)


async def amain(args, factory=None) -> dict:
    """Serve, warm up, sweep the rates and write the JSON files. `factory`
    replaces the random-weight factory (e.g. weights carried over). Returns
    the rows, the table, each rate's BenchmarkResult and the cluster's
    metrics just before and just after the timed sweep."""
    from benchmark.benchmark import run_benchmark
    from benchmark.metric import slo_attainment
    from benchmark.performance_analyzer import summarize

    from ..cluster.cluster import Cluster, ClusterConfig, NodeSpec
    from ..entrypoint.api_server import APIServer, APIServerConfig
    from ..models.random_init import RandomWeightFactory
    from ..utils.socket_utils import find_free_port

    if factory is None:
        factory = RandomWeightFactory(args.arch, multimodal=args.image_ratio > 0,
                                      quantization=args.quant,
                                      kv_scale=0.05 if args.kv_int8 else None,
                                      device=args.device)
    cfg = ClusterConfig(nodes=[NodeSpec("EPD" if args.image_ratio > 0 else "PD", 1)],
                        node=node_config(args, factory),
                        platform="cpu" if args.device == "cpu" else None)
    cluster = Cluster(cfg, model_factory=factory)
    port = find_free_port()
    server = APIServer(APIServerConfig(port=port), factory.getTokenizer(),
                       image_token="<image>")
    server.register_observer(cluster)
    await cluster.start()
    runner = await server.start()
    base = f"http://127.0.0.1:{port}"

    os.makedirs(args.out, exist_ok=True)
    entries = make_entries(args)
    try:
        # warm-up: the FULL entry set, twice over, before any timed request.
        # Boot captured the decode graphs at the max batch; these passes meet
        # the decode keys of smaller batches and, in the second pass, the
        # shorter prefill shapes that prefix-cache hits of already-seen
        # prompts produce (the measured sweeps re-submit these same entries,
        # so their prefill shapes are the second pass's). Prefill runs
        # eagerly and compiles nothing; a decode key first met in the timed
        # sweep is captured there, and `sweep_metrics` shows it.
        await run_benchmark(base, entries, 1e9, "uniform")
        await run_benchmark(base, entries, 1e9, "uniform")
        before = cluster.metrics()
        rows, results = [], {}
        for rate in args.rates:
            result = await run_benchmark(base, entries, rate, args.arrival,
                                         trace_path=args.trace_path or None)
            analysis = result.analyze()
            analysis["slo"] = slo_attainment(result, args.ttft_slo,
                                             args.tpot_slo)
            if args.gap_slo:
                # attainment at a LADDER of per-token gap SLOs: one run
                # yields the whole strictness curve
                analysis["slo_strict"] = {
                    str(g): slo_attainment(result, args.ttft_slo,
                                           args.tpot_slo, gap_p99_slo=g)
                    for g in args.gap_slo}
            with open(os.path.join(args.out, f"rate_{rate}.json"), "w") as f:
                json.dump(analysis, f, indent=1)
            rows.append(analysis)
            results[rate] = result
        after = cluster.metrics()
        table = summarize(rows)
        print(json.dumps(table, indent=1))
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump({"arch": args.arch, "ttft_slo": args.ttft_slo,
                       "tpot_slo": args.tpot_slo, "gap_slo": args.gap_slo,
                       "multi_step": args.multi_step,
                       "arrival": args.arrival,
                       "trace_path": args.trace_path,
                       "quant": args.quant, "kv_int8": args.kv_int8,
                       "entries": args.entries or "synthetic",
                       "image_ratio": args.image_ratio,
                       "strict": [r.get("slo_strict") for r in rows],
                       "table": table,
                       "device": device_label(args.device)}, f, indent=1)
    finally:
        await cluster.stop()
        await runner.cleanup()
    return {"rows": rows, "table": table, "results": results, "entries": entries,
            "sweep_metrics": {"before": before, "after": after}}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-2b-lm")
    ap.add_argument("--rates", type=float, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--num-requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--min-prompt-len", type=int, default=32)
    ap.add_argument("--max-prompt-len", type=int, default=256)
    ap.add_argument("--min-output-len", type=int, default=32)
    ap.add_argument("--max-output-len", type=int, default=128)
    ap.add_argument("--image-ratio", type=float, default=0.0)
    ap.add_argument("--entries", default="",
                    help="dataset entries JSON (benchmark.data_preprocess "
                         "output) instead of synthetic entries; image "
                         "entries require --image-ratio > 0 so the engine "
                         "boots the vision tower")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pin the KV pool size (0 = size from the workload)")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4", "fp8"])
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "uniform", "mooncake", "azure",
                             "burstgpt"],
                    help="arrival process; trace methods replay a trace "
                         "file's inter-arrival pattern rescaled to each "
                         "rate (reference: benchmark/timestamp.py:9-60)")
    ap.add_argument("--trace-path", default="",
                    help="trace file for --arrival mooncake/azure/burstgpt "
                         "(evaluation/make_bursty_traces.py synthesizes "
                         "format-exact bursty traces without a download)")
    ap.add_argument("--ttft-slo", type=float, default=5.0)
    ap.add_argument("--tpot-slo", type=float, default=0.1)
    ap.add_argument("--gap-slo", type=float, nargs="*", default=[],
                    help="also report STRICT attainment at these per-token "
                         "gap SLOs: per-request p99 inter-token gap must "
                         "meet each level (seconds)")
    ap.add_argument("--multi-step", type=int, default=0,
                    help="fused decode window K (0 = node default) — the "
                         "burstiness/throughput dial the strict SLO trades "
                         "against")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default="result/slo")
    return ap


def parse_args(argv=None):
    args = parser().parse_args(argv)
    if args.tiny:
        args.rates = [4]
        args.num_requests = 6
        args.min_prompt_len, args.max_prompt_len = 8, 16
        args.min_output_len, args.max_output_len = 4, 8
        args.max_batch = 4
    return args


def main():
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
