#!/usr/bin/env python3
"""K4's int4 and fp8 forms over candidate launch plans, on the card.

    python3 k4_plan_sweep.py [--out chip_smoke_out/k4_plan_sweep.json]

For llava-7b-lm's four layer projections (qkv, o, gate_up, down), each
weight N(0, 1/K) quantized on the card (int4 at group 128 and per column,
fp8 per column), times every candidate (form, bn, splits) of
`ops/cuda/quant_matmul.py` at the decode rows (M 8 and 16: the skinny
form's strips and split counts) and the prefill rows (M 256 and 512: the tma
form's split counts 1-8), each launch from a CUDA graph over rotating weight
copies (no launch finds its weight in L2), checked against the plain version
first, beside `plan`'s own choice and torch.mm on the weight dequantized to
bf16. This is how `plan`'s rules were chosen; nothing on the serving path
runs it. Prints a line a case and writes the JSON (with the card's name and
power limit) to --out. Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import json
import math
import os
import sys

import torch

import chip_smoke as cs
from hydrainfer_tpu_torch.ops.cuda import build
from hydrainfer_tpu_torch.ops.cuda import quant_matmul as qmm
from hydrainfer_tpu_torch.ops.quant import quantize_fp8, quantize_int4

# llava-7b-lm's layer projections (K, N)
SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096)}
FORMS = (("int4", 128), ("int4", 0), ("fp8", 0))
DECODE_M, PREFILL_M = (8, 16), (256, 512)


def candidates(M: int, K: int) -> list:
    """(form, bn, splits) plans the kernel takes at M rows: every strip and
    split count of the skinny form, or the tma form's split counts 1-8."""
    if M <= qmm.SKINNY_MAX_M:
        return [("skinny", bn, s) for bn in (64, 128, 256) for s in (1, 2, 3, 4, 5, 6, 8)]
    return [("tma", qmm.TMA_COLS, s) for s in (1, 2, 3, 4, 6, 8)
            if s <= max(1, -(-K // qmm.BK) // qmm.MIN_SLICE_TILES)]


def graph_ms(calls, reps: int = 30) -> float:
    """ms a call: the calls captured in one CUDA graph, replayed `reps` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def sweep_case(fmt: str, group: int, M: int, K: int, N: int, qt, copies, gen) -> dict:
    dev = qt.q.device
    x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    plain = qmm.quant_matmul_int4_plain if fmt == "int4" else qmm.quant_matmul_fp8_plain
    ref = plain(x, qt.q, qt.scale, group, torch.float32)
    tol = 2e-2 * max(1.0, ref.abs().max().item())
    name = f"quant_matmul_{fmt}"
    rows = []
    for form, bn, splits in candidates(M, K):
        def call(q, form=form, bn=bn, splits=splits):
            build.launch(name, x.data_ptr(), q.data_ptr(), qt.scale.data_ptr(), out.data_ptr(),
                         M, K, N, group, 1, 1, qmm.FORM_CODES[form], bn, splits)
        call(qt.q)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if err > tol:
            raise AssertionError(f"{fmt} g{group} M{M} {form} {bn} x {splits}: error {err}")
        rows.append({"form": form, "bn": bn, "splits": splits,
                     "graph_ms": graph_ms([lambda q=q: call(q) for q in copies])})
    w_bf = qmm.dequantize_weight(qt.q, qt.scale, fmt, group, torch.bfloat16)
    bfs = [w_bf] + [w_bf.clone() for _ in range(math.ceil(120e6 / (2 * K * N)) - 1)]
    mm = graph_ms([lambda b=b: torch.mm(x, b) for b in bfs])
    p = qmm.plan(M, K, N, fmt)
    planned = [r for r in rows if (r["form"], r["bn"], r["splits"]) == (p.form, p.bn, p.splits)]
    return {"plan": [p.form, p.bn, p.splits],
            "plan_ms": planned[0]["graph_ms"] if planned else None,
            "best": min(rows, key=lambda r: r["graph_ms"]), "torch_mm_ms": mm, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chip_smoke_out/k4_plan_sweep.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    res = {"gpu": cs.gpu_name_and_limit(), "cases": {}}
    gen = torch.Generator().manual_seed(0)
    for proj, (K, N) in SHAPES.items():
        w = (torch.randn((K, N), generator=gen) / math.sqrt(K)).to(dev)
        for fmt, group in FORMS:
            qt = quantize_int4(w, group=group) if fmt == "int4" else quantize_fp8(w)
            nbytes = qt.q.numel() + 4 * qt.scale.numel()
            copies = [qt.q] + [qt.q.clone() for _ in range(math.ceil(120e6 / nbytes) - 1)]
            for M in DECODE_M + PREFILL_M:
                case = sweep_case(fmt, group, M, K, N, qt, copies, gen)
                key = f"{proj}_{fmt}_g{group}_M{M}"
                res["cases"][key] = case
                print(key, "plan", case["plan"], round(case["plan_ms"], 4), "best",
                      case["best"]["form"], case["best"]["bn"], case["best"]["splits"],
                      round(case["best"]["graph_ms"], 4), "torch.mm", round(case["torch_mm_ms"], 4),
                      flush=True)
            del copies
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
