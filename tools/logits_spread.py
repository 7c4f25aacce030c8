#!/usr/bin/env python3
"""How far the bf16 int8-KV prefill through the kernels lies from the f32 run,
beside the same prefill through the plain PyTorch versions, over many
prompts: the spread of chip_smoke.py's image-prefill logits check.

    python3 tools/logits_spread.py [--families internvl,llavanext]
        [--seeds 9,10,11,12,13,14,15] [--out chiprun_out/logits_spread.json]

On one H100. For each family (chip_smoke.py's LLaVA-NeXT-13B and
InternVL2-8B factories, random weights from its seed) and each seed, the
image-bearing prompt of the family's longest image (chip_smoke's measured
round; 24 + image tokens + 40 text tokens drawn from the seed) is
prefilled in chunks of 2048 and held by chip_smoke._image_prefill_check:
once reading each chunk's last row (`every` 0: the max |error| criterion)
and once every 64th row too (`every` 64: the mean |error| criterion);
both ratios (kernels over plain, max and mean |error| from the f32 run) are
printed for each. With --swap, each of the kernels K2, K3 and K4 is also
replaced by its plain version alone in the bf16 run of the last-row check,
to see whether one kernel carries the distance. Imports nothing of JAX."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def swap_errors(cs, factory, req, seed, dev) -> dict:
    """The last-row check's bf16 distance from the f32 run (max and mean
    |error|) with every kernel, with the plain versions, and with one kernel
    swapped for its plain version at a time."""
    from dataclasses import replace
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.models.factory import VisionModelParameters
    from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM
    from hydrainfer_tpu_torch.ops import attention, cache_ops, quant
    from hydrainfer_tpu_torch.ops.cuda import (kv_writer, mha_decode, paged_attention,
                                               quant_matmul)
    plain = {"K4": (quant, "quant_matmul_int8", quant_matmul.quant_matmul_int8_plain),
             "K3": (cache_ops, "write_kv_pages", kv_writer.write_kv_pages_plain),
             "K1": (attention, "mha_decode_attention", mha_decode.mha_decode_attention_plain),
             "K2": (attention, "paged_attention_varlen",
                    paged_attention.paged_attention_varlen_plain)}
    kernel = {k: getattr(m, n) for k, (m, n, _) in plain.items()}

    def run(lm, tokens, swapped, **kw):
        for k, (m, n, f) in plain.items():
            setattr(m, n, f if k in swapped else kernel[k])
        try:
            with torch.no_grad():
                return cs._prefill_logits(lm, tokens, dev, **kw)
        finally:
            for k, (m, n, _) in plain.items():
                setattr(m, n, kernel[k])

    size = (req.image.height, req.image.width)
    with torch.no_grad():
        feats = factory.getVisionModel().forward(
            factory.getProcessor().process(req.image),
            VisionModelParameters(original_image_sizes=[size])).image_features[0]
    n = factory.getVisionModelConfig().image_token_calculator.get_num_image_tokens(size)
    rng = np.random.default_rng(cs.SEED + seed)
    text = [int(t) for t in rng.integers(10, 120, size=64)]
    tokens = text[:24] + [9] * n + text[24:]
    kw = dict(image_features=feats, image_dst_idx=list(range(24, 24 + n)), chunk=2048)
    lm = factory.getLanguageModel()
    lm32 = LlamaForCausalLM(cs._f32_weights(lm.weights), replace(lm.cfg, kv_scale=None))
    ref = run(lm32, tokens, set(plain), **kw)
    del lm32
    out = {}
    for name, swapped in (("kernels", set()), ("plain", set(plain)), ("K2 plain", {"K2"}),
                          ("K3 plain", {"K3"}), ("K4 plain", {"K4"})):
        d = (run(lm, tokens, swapped, **kw) - ref).abs()
        out[name] = {"max": d.max().item(), "mean": d.mean().item()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default="internvl,llavanext")
    ap.add_argument("--seeds", default="9,10,11,12,13,14,15")
    ap.add_argument("--swap", action="store_true")
    ap.add_argument("--out", default="chiprun_out/logits_spread.json")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("logits_spread: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hydrainfer_tpu_torch.ops.cuda import build
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    out = {"gpu": cs.gpu_name_and_limit()}
    for family in args.families.split(","):
        if family == "internvl":
            factory, images, idx = cs._internvl_factory(dev), cs.INTERNVL_IMAGES, 3
        else:
            factory, images, idx = cs._next_factory(dev), cs.NEXT_IMAGES, 0
        req = cs._mm_requests(images, cs._MM_SEEDS["measured"], "spread")[idx]
        rows = []
        for seed in (int(s) for s in args.seeds.split(",")):
            for every in (0, 64):
                r = cs._image_prefill_check(factory, req, np.random.default_rng(cs.SEED + seed),
                                            dev, chunk=2048, every=every)
                row = {"seed": seed, "every": every, "ok": r["ok"],
                       **{k[len("image_prefill_logits_"):]: v for k, v in r.items()
                          if k.startswith("image_prefill_logits_") and "tolerance" not in k}}
                if args.swap and every == 0:
                    row["swaps"] = swap_errors(cs, factory, req, seed, dev)
                rows.append(row)
                print(json.dumps({"family": family, **row}), flush=True)
        out[family] = rows
        del factory
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for family in args.families.split(","):
        for every in (0, 64):
            sel = [r for r in out[family] if r["every"] == every]
            print(f"{family} every={every}: max ratio {min(r['bf16_ratio'] for r in sel):.3f}"
                  f"-{max(r['bf16_ratio'] for r in sel):.3f}, mean ratio "
                  f"{min(r['bf16_mean_ratio'] for r in sel):.4f}-"
                  f"{max(r['bf16_mean_ratio'] for r in sel):.4f}, checks passing "
                  f"{sum(r['ok'] for r in sel)}/{len(sel)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
