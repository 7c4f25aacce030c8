"""Encode / prefill / decode interference (port of evaluation/interference.py).

On one card every stage runs on one stream, so an encode (a ViT forward) or
a long prefill chunk queued between decode steps stretches every running
request's token gap by the intruder's whole device time: head-of-line
blocking. This script times the stages alone (decode of text requests on a
PD node; image encodes on an EPD node) and then the colocated mix (the text
workload with every fourth request carrying an image, on the EPD node), and
reports how much the colocated node inflates the decode token gaps: what an
E / P / D split buys back.

Usage (card): python -m hydrainfer_tpu_torch.evaluation.interference --arch qwen2-vl-2b-lm
      (CPU):  python -m hydrainfer_tpu_torch.evaluation.interference --tiny --arch tiny-lm --device cpu

Prints a markdown table and, with --out, writes the JSON there.
"""
import argparse
import json
import string
import time
import zlib

import numpy as np

IMAGE_SIZE = 336        # the side of every request's square random image

def _engine(factory, n_kv_blocks, n_image_blocks, image_block_size, max_running,
            node_type, encode_chunk_layers=0, device=None):
    from ..cluster.node import NodeConfig
    from ..engine.request_processor import RequestProcessorConfig
    from ..engine.scheduler import BatchSchedulerConfig
    from ..entrypoint.offline import OfflineEngine
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=max_running,
                                             priority="prefill"),
        request_processor=RequestProcessorConfig(num_request_process_workers=1),
        kv_block_size=16, n_kv_blocks=n_kv_blocks, n_image_blocks=n_image_blocks,
        image_block_size=image_block_size,
        # a read every step: interference shows in the raw token gaps
        postprocess_batch_steps=1, adaptive_postprocess=False, async_pipeline_depth=2,
        # the key floors raised and the decode keys met at boot, so that no
        # measured round meets a new key
        boot_warmup=True, encode_chunk_layers=encode_chunk_layers)
    return OfflineEngine(cfg, model_factory=factory, node_type=node_type, device=device)


def _requests(n, prompt_len, max_tokens, image_every=0, image_size=IMAGE_SIZE, tag="r"):
    from PIL import Image

    from ..request import Request, SamplingParameters
    # distinct prompts a tag: a measured round that repeated a warm-up's
    # prompts would hit the prefix cache and prefill other shapes
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    reqs = []
    for i in range(n):
        prompt = "".join(rng.choice(list(string.ascii_lowercase + " "), size=prompt_len))
        image = None
        if image_every and i % image_every == 0:
            image = Image.fromarray(rng.integers(0, 255, (image_size, image_size, 3),
                                                 dtype=np.uint8))
            prompt = "<image> " + prompt
        reqs.append(Request(request_id=f"{tag}{i}", prompt=prompt, image=image,
                            sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                               ignore_eos=True)))
    return reqs


def _token_gaps(outs):
    gaps = [np.diff(o.token_times) for o in outs if len(o.token_times) > 1]
    return np.concatenate(gaps) if gaps else np.array([0.0])


def stage_stats(outs, elapsed: float) -> dict:
    """One stage's row: wall, p50 TTFT, token-gap percentiles, tokens/s."""
    gaps = _token_gaps(outs)
    return {
        "elapsed_s": round(elapsed, 3),
        "ttft_p50_s": round(float(np.median([o.ttft for o in outs])), 4),
        "tbt_p50_s": round(float(np.median(gaps)), 5),
        "tbt_p90_s": round(float(np.percentile(gaps, 90)), 5),
        "tbt_p99_s": round(float(np.percentile(gaps, 99)), 5),
        "tokens_per_s": round(sum(len(o.output_token_ids) for o in outs) / elapsed, 1),
    }


def interference_of(stages: dict) -> dict:
    """The colocated node's decode token gaps and throughput over decode's alone."""
    d, c = stages["decode_only"], stages["colocated_epd"]
    return {
        "decode_tbt_p90_inflation": round(c["tbt_p90_s"] / max(d["tbt_p90_s"], 1e-9), 2),
        "decode_tbt_p99_inflation": round(c["tbt_p99_s"] / max(d["tbt_p99_s"], 1e-9), 2),
        "decode_throughput_ratio": round(c["tokens_per_s"] / max(d["tokens_per_s"], 1e-9),
                                         3),
    }


def run_analysis(arch: str, tiny: bool = False, batch: int = 16, prompt_len: int = 128,
                 gen: int = 64, encode_chunk_layers: int = 0, device=None,
                 factories=None) -> dict:
    """factories: (text, multimodal) ModelFactories to serve instead of
    random weights at `arch` (the multimodal one with a random CLIP tower,
    CLIP_TINY where the arch name has "tiny"); the text one serves the
    decode-only PD node, the multimodal one the EPD node."""
    from ..models.random_init import CLIP_TINY, RandomWeightFactory
    if tiny:
        batch, prompt_len, gen = 4, 16, 12
    if factories is None:
        clip = CLIP_TINY if "tiny" in arch else None
        factories = (RandomWeightFactory(arch, device=device),
                     RandomWeightFactory(arch, device=device, multimodal=True,
                                         clip_cfg=clip))
    text_factory, mm_factory = factories
    results = {}

    def measure(name, engine, make_reqs, *warm_factories):
        # two warm passes with their own prompts (batch composition varies
        # with timing, so one pass may leave a shape for the measured pass
        # to meet); requests are made after the warm-up, since arrival is
        # stamped when a request is made
        for warm in warm_factories:
            engine.generate(warm(), timeout_s=1200)
        reqs = make_reqs()
        t0 = time.perf_counter()
        outs = engine.generate(reqs, timeout_s=1200)
        results[name] = stage_stats(outs, time.perf_counter() - t0)
        return outs

    # 1. decode alone: text requests on a PD node
    kv_blocks = max(256, 2 * batch * (prompt_len + gen) // 16)
    eng = _engine(text_factory, kv_blocks, 1, -1, batch, "PD", device=device)
    measure("decode_only", eng,
            lambda: _requests(batch, prompt_len, gen, tag="d"),
            lambda: _requests(batch, prompt_len, gen, tag="dw"),
            lambda: _requests(batch, prompt_len, gen, tag="dw2"))
    del eng

    # 2 + 3. an EPD node: image encodes alone, then the text workload with
    # every fourth request carrying an image
    calc = mm_factory.getVisionModelConfig().image_token_calculator
    img_tokens = calc.get_num_image_tokens((IMAGE_SIZE, IMAGE_SIZE))
    eng = _engine(mm_factory, kv_blocks, max(8, batch), img_tokens, batch, "EPD",
                  encode_chunk_layers=encode_chunk_layers, device=device)

    def images(n, p, g, tag, every):
        return lambda: _requests(n, p, g, image_every=every, tag=tag)
    measure("encode_only", eng, images(batch // 2, 4, 2, "e", 1),
            images(batch // 2, 4, 2, "ew", 1), images(batch // 2, 4, 2, "ew2", 1))
    measure("colocated_epd", eng, images(batch, prompt_len, gen, "c", 4),
            images(batch, prompt_len, gen, "cw", 4), images(batch, prompt_len, gen, "cw2", 4))
    del eng
    return {"arch": arch, "batch": batch, "prompt_len": prompt_len, "gen": gen,
            "image_tokens": img_tokens, "encode_chunk_layers": encode_chunk_layers,
            "stages": results, "interference": interference_of(results)}


def to_markdown(r) -> str:
    lines = [
        f"# Interference analysis — {r['arch']} "
        f"(b{r['batch']}, prompt {r['prompt_len']}, gen {r['gen']})",
        "",
        "| stage | tok/s | ttft p50 | tbt p50 | tbt p90 | tbt p99 |",
        "|---|---|---|---|---|---|",
    ]
    for name, s in r["stages"].items():
        lines.append(f"| {name} | {s['tokens_per_s']} | {s['ttft_p50_s']}s "
                     f"| {s['tbt_p50_s']}s | {s['tbt_p90_s']}s | {s['tbt_p99_s']}s |")
    i = r["interference"]
    lines += [
        "",
        f"Colocating encode with decode inflates decode TBT p90 by "
        f"**{i['decode_tbt_p90_inflation']}x** (p99 "
        f"{i['decode_tbt_p99_inflation']}x) and moves decode throughput by "
        f"{i['decode_throughput_ratio']}x — on one card every stage runs on one "
        "stream, so the ViT forward blocks the decode steps queued behind it, "
        "which is what an E/P/D split removes.",
    ]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-2b-lm")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--tiny", action="store_true", help="tiny shapes for CPU smoke runs")
    ap.add_argument("--encode-chunk-layers", type=int, default=0,
                    help="layer-chunked encode segment size for the colocated engine "
                         "(0 = whole tower)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write JSON here")
    args = ap.parse_args()
    r = run_analysis(args.arch, tiny=args.tiny, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen,
                     encode_chunk_layers=args.encode_chunk_layers, device=args.device)
    print(to_markdown(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)


if __name__ == "__main__":
    main()
