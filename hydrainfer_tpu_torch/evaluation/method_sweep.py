"""Disaggregation method sweep through the process deployment (port of
evaluation/method_sweep.py).

One layout of each disaggregation family, epd (colocated), ep_d, ed_p and
e_p_d, served end to end: node processes spawned by ProcessCluster
(cluster/process_node.py), a tiny random model with a tiny CLIP tower
(`random:tiny-lm+mm`), mixed text and image requests, KV and image-cache
migration at every stage boundary. Per method it reports completion, wall
time, tokens/s and whether every request's greedy tokens equal the
colocated layout's: the same weights must give the same tokens however the
pipeline is cut, which is the sweep's correctness signal.

  python -m hydrainfer_tpu_torch.evaluation.method_sweep --device cpu [--out FILE]

The JAX original is a CPU driver; on the card (the default device) every
node process takes the card in turn.
"""
import argparse
import asyncio
import json
import os
import time

import numpy as np

METHODS = {
    "epd":   [("EPD", 1)],
    "ep_d":  [("EP", 1), ("D", 1)],
    "ed_p":  [("ED", 1), ("P", 1)],
    "e_p_d": [("E", 1), ("P", 1), ("D", 1)],
}


def make_requests(n: int, max_tokens: int):
    from PIL import Image

    from ..request import Request, SamplingParameters
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 255, (56, 56, 3), dtype=np.uint8))
    reqs = []
    for i in range(n):
        has_img = i % 2 == 0
        reqs.append(Request(
            request_id=f"m{i}",
            prompt=(("<image> describe image " if has_img else "plain text ")
                    + f"request number {i} with some padding words"),
            image=img if has_img else None,
            sampling_params=SamplingParameters(max_tokens=max_tokens, ignore_eos=True)))
    return reqs


async def run_method(name: str, layout, n_requests: int, max_tokens: int,
                     arrival_s: float, platform=None) -> dict:
    """Serve the requests on `layout` ([(node type, replicas)]), platform
    "cpu" or None (the card)."""
    from ..cluster.cluster import NodeSpec
    from ..cluster.node import NodeConfig
    from ..cluster.process_node import ProcessCluster, ProcessClusterConfig
    from ..engine.output_token_processor import LogOutputTokenProcessor
    from ..engine.request_processor import RequestProcessParameters

    node = NodeConfig(kv_block_size=4, n_kv_blocks=512, n_image_blocks=32)
    node.model.name = "random:tiny-lm+mm"
    node.model.dtype = "float32"
    node.request_processor.block_size = 4
    node.request_processor.num_request_process_workers = 1
    node.batch_scheduler.max_running_requests = 8
    node.log_latency_breakdown = True

    cluster = ProcessCluster(ProcessClusterConfig(
        nodes=[NodeSpec(nt, n) for nt, n in layout], node=node, platform=platform))
    procs = [LogOutputTokenProcessor() for _ in range(n_requests)]
    reqs = make_requests(n_requests, max_tokens)
    t0 = time.perf_counter()
    try:
        await cluster.start()
        boot_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for req, proc in zip(reqs, procs):
            await cluster.add_request(
                req, RequestProcessParameters(output_token_processors=[proc]))
            await asyncio.sleep(arrival_s)
        deadline = time.time() + 600
        while not all(p.finished for p in procs):
            assert time.time() < deadline, (
                f"{name}: stalled with {sum(p.finished for p in procs)}/{n_requests} "
                "finished")
            await asyncio.sleep(0.05)
        wall = time.perf_counter() - t1
    finally:
        await cluster.stop()
    tokens = [p.token_ids for p in procs]
    total = sum(len(t) for t in tokens)
    return {
        "layout": [f"{nt}x{n}" for nt, n in layout],
        "boot_s": round(boot_s, 2),
        "wall_s": round(wall, 2),
        "tokens_per_s": round(total / wall, 2),
        "all_finished": all(len(t) == max_tokens for t in tokens),
        "tokens": tokens,
    }


async def sweep(methods=tuple(METHODS), num_requests=12, max_tokens=8, arrival_s=0.05,
                platform=None, log=print) -> dict:
    """Every method in turn; each result's `tokens` is replaced by
    `tokens_match_epd` (the first method is the reference)."""
    results = {}
    for name in methods:
        layout = METHODS[name]
        log(f"== {name}: {layout}")
        results[name] = await run_method(name, layout, num_requests, max_tokens, arrival_s,
                                         platform)
        log(f"   {results[name]['tokens_per_s']} tok/s, "
            f"finished={results[name]['all_finished']}")
    base = results[methods[0]]["tokens"]
    for r in results.values():
        r[f"tokens_match_{methods[0]}"] = r.pop("tokens") == base
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="method_sweep_torch.json")
    ap.add_argument("--num-requests", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--arrival-s", type=float, default=0.05)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    platform = "cpu" if args.device == "cpu" else None
    results = asyncio.run(sweep(num_requests=args.num_requests, max_tokens=args.max_tokens,
                                arrival_s=args.arrival_s, platform=platform,
                                log=lambda s: print(s, flush=True)))
    payload = {
        "methodology": ("one layout per disaggregation family, spawned node processes "
                        f"on the {args.device}, a tiny random-weight model with a CLIP "
                        f"tower, {args.num_requests} mixed text/image requests at "
                        f"{args.arrival_s}s spacing; tokens_match_epd = greedy tokens "
                        "identical to the colocated layout"),
        "results": results,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(results, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
