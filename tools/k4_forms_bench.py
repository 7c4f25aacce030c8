#!/usr/bin/env python3
"""K4's weight formats side by side at llava-7b-lm's four layer projections.

    python3 tools/k4_forms_bench.py [--m 16,256] [--out chip_smoke_out/k4_forms.json]

On one H100. For each M, the four projections (qkv, o, gate_up, down) summed,
from CUDA graphs over rotating weight copies (no launch finds its weight in
L2; chip_smoke.graph_ms), for int8 (per column), int4 (group 128 and per
column) and fp8 (per column and group 128), each weight N(0, 1/K) quantized on
the card by the port's quantize functions and checked against its plain
version first; beside each its byte bound (the stored weight bytes, x and the
bf16 output over 3.35 TB/s) and torch.mm on the bf16 weight. Prints one JSON
line and writes it to --out. Imports nothing of JAX."""
import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (label, quantization, group)
FORMS = [("int8", "int8", 0), ("int4_g128", "int4", 128), ("int4_col", "int4", 0),
         ("fp8_col", "fp8", 0), ("fp8_g128", "fp8", 128)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", default="16,256")
    ap.add_argument("--out", default="chip_smoke_out/k4_forms.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k4_forms_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hydrainfer_tpu_torch.models.random_init import (ARCH_CONFIGS, int8_matmul_shapes,
                                                         quant_weight_bytes)
    from hydrainfer_tpu_torch.ops import quant as q
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    shapes = {k: v for k, v in int8_matmul_shapes(ARCH_CONFIGS["llava-7b-lm"]).items()
              if k != "lm_head"}
    ms = [int(m) for m in args.m.split(",")]
    res = {"gpu": cs.gpu_name_and_limit(), "shapes": shapes, "M": ms, "forms": {}}
    for label, mode, group in FORMS:
        rows = {m: {"graph_ms": 0.0, "bound_ms": 0.0, "torch_mm_graph_ms": 0.0} for m in ms}
        ok = True
        for name, (K, N) in shapes.items():
            w = (torch.randn((K, N), generator=gen) / math.sqrt(K)).to(dev)
            qt = (q.quantize_int8(w) if mode == "int8" else
                  q.quantize_int4(w, group=group) if mode == "int4" else
                  q.quantize_fp8(w, group=group))
            fmt = q._fmt(qt)
            w_bytes = quant_weight_bytes(K, N, fmt, qt.group)
            copies = [qt.q] + [qt.q.clone() for _ in range(math.ceil(120e6 / w_bytes) - 1)]
            w_bf = q.dequantize(qt, torch.bfloat16)
            del w
            for m in ms:
                x = torch.randn((m, K), generator=gen).to(dev, torch.bfloat16)
                got = q.qmatmul(x, qt).float()
                with cs._Plain():
                    ref = q.qmatmul_f32(x, qt)
                ok &= (got - ref).abs().max().item() <= 2e-2 * max(1.0, ref.abs().max().item())
                it = iter(range(10 ** 9))
                call = (lambda: q.qmatmul(x, q.QuantizedTensor(
                    copies[next(it) % len(copies)], qt.scale, qt.bits, qt.fmt, qt.group)))
                rows[m]["graph_ms"] += cs.graph_ms(call)
                rows[m]["bound_ms"] += cs.bound_ms(m * K * 2 + w_bytes + m * N * 2,
                                                   2.0 * m * K * N)[0]
                rows[m]["torch_mm_graph_ms"] += cs.graph_ms(lambda: torch.mm(x, w_bf))
            del copies, w_bf, qt
        res["forms"][label] = {"ok": bool(ok), **{f"M{m}": rows[m] for m in ms}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0 if all(r["ok"] for r in res["forms"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
