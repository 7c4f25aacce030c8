"""The port's engine-driven speed drivers (hydrainfer_tpu_torch/evaluation:
interference, ab_bench, spec_bench, method_sweep) against the JAX package's
`evaluation/` twins, on the CPU: ab_bench's variant grammar (the ported keys
parse as JAX parses them; the TPU-only keys are refused by name),
interference's token-gap math and markdown table on the same input, the
interference and spec_bench command lines end to end at --tiny on tiny-lm,
and method_sweep's cross-method token equality (epd against e_p_d, node
processes on the CPU)."""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import importlib
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from hydrainfer_tpu_torch.evaluation import (ab_bench, interference, method_sweep,
                                             spec_bench)


@pytest.fixture
def jax_driver(monkeypatch):
    """Imports a JAX driver module; its import-time setdefault of the JAX
    compile-cache directory is undone when the test ends."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    return lambda name: importlib.import_module(f"evaluation.{name}")


def test_ab_variants_parse_as_jax_and_refuse_tpu_only_keys(jax_driver):
    jax_ab = jax_driver("ab_bench")
    spec = ("fp8;quant=fp8;kv_int8=1;kv_blocks=300;multi_step=16;block_size=32;depth=3;"
            "post_k=2")
    port, ref = ab_bench.parse_variant(spec), jax_ab.parse_variant(spec)
    assert port == {k: ref[k] for k in port}
    assert set(port) == {"label", "quant", "kv_int8", "kv_blocks", "multi_step",
                         "block_size", "depth", "post_k"}
    bare = ab_bench.parse_variant("base")
    assert bare == {k: jax_ab.parse_variant("base")[k] for k in bare}
    for key, value in (("layer_loop", "scan"), ("kv_ref", "0"), ("pipeline", "sync"),
                       ("kv_pages_per_block", "4"), ("pallas_qmm", "1"),
                       ("attn_impl", "jnp"), ("bisect", "no-attn")):
        jax_ab.parse_variant(f"v;{key}={value}")       # a JAX key...
        with pytest.raises(ValueError, match=f"'{key}'.*TPU-only machinery"):
            ab_bench.parse_variant(f"v;{key}={value}")   # ...refused by name
    with pytest.raises(AssertionError, match="unknown variant key"):
        ab_bench.parse_variant("v;warp_size=32")


def test_interference_math_and_markdown_equal_jax(jax_driver):
    jax_if = jax_driver("interference")
    rng = np.random.default_rng(0)
    outs = [SimpleNamespace(token_times=list(np.cumsum(rng.exponential(0.01, n))),
                            ttft=float(rng.uniform(0.05, 0.2)), output_token_ids=[0] * n)
            for n in (1, 5, 9, 16)]
    np.testing.assert_array_equal(interference._token_gaps(outs), jax_if._token_gaps(outs))
    np.testing.assert_array_equal(interference._token_gaps(outs[:1]),
                                  jax_if._token_gaps(outs[:1]))
    gaps = jax_if._token_gaps(outs)
    row = interference.stage_stats(outs, 0.731)
    assert row == {     # JAX's measure() rounds the same figures the same way
        "elapsed_s": round(0.731, 3),
        "ttft_p50_s": round(float(np.median([o.ttft for o in outs])), 4),
        "tbt_p50_s": round(float(np.median(gaps)), 5),
        "tbt_p90_s": round(float(np.percentile(gaps, 90)), 5),
        "tbt_p99_s": round(float(np.percentile(gaps, 99)), 5),
        "tokens_per_s": round(31 / 0.731, 1)}
    stages = {"decode_only": row, "encode_only": interference.stage_stats(outs[1:], 0.2),
              "colocated_epd": interference.stage_stats(outs[2:], 1.5)}
    r = {"arch": "tiny-lm", "batch": 4, "prompt_len": 16, "gen": 12, "image_tokens": 16,
         "encode_chunk_layers": 0, "stages": stages,
         "interference": interference.interference_of(stages)}
    d, c = stages["decode_only"], stages["colocated_epd"]
    assert r["interference"]["decode_tbt_p90_inflation"] == round(
        c["tbt_p90_s"] / max(d["tbt_p90_s"], 1e-9), 2)
    port_md, jax_md = interference.to_markdown(r), jax_if.to_markdown(r)
    # the table and every figure are JAX's; the closing clause names the
    # port's device instead of the TPU
    assert port_md.split(" — on ")[0] == jax_md.split(" — on ")[0]
    assert port_md.count("\n") == jax_md.count("\n")


def _main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()
    return capsys.readouterr().out


def test_interference_tiny_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    out = _main(interference, ["--tiny", "--arch", "tiny-lm", "--device", "cpu",
                               "--out", str(tmp_path / "r.json")], monkeypatch, capsys)
    r = json.loads((tmp_path / "r.json").read_text())
    assert (r["batch"], r["prompt_len"], r["gen"], r["image_tokens"]) == (4, 16, 12, 16)
    assert list(r["stages"]) == ["decode_only", "encode_only", "colocated_epd"]
    for s in r["stages"].values():
        assert s["tokens_per_s"] > 0 and s["elapsed_s"] > 0
    assert r["interference"]["decode_throughput_ratio"] > 0
    assert "| colocated_epd |" in out and "Interference analysis — tiny-lm" in out


def test_spec_bench_tiny_runs_on_the_cpu(monkeypatch, capsys):
    out = _main(spec_bench, ["--tiny", "--device", "cpu"], monkeypatch, capsys)
    r = json.loads(out.strip().splitlines()[-1])
    assert (r["arch"], r["batch"], r["spec_k"]) == ("tiny-lm", 2, 3)
    assert r["base_tokens_per_s"] > 0 and r["spec_tokens_per_s"] > 0
    assert r["spec_steps"] > 0, "the lookup-friendly prompt drafted nothing"
    assert out.count("# round") == 2


def test_spec_bench_tokens_equal_greedy():
    keep = {}
    spec_bench.run_spec_bench("tiny-lm", batch=2, max_tokens=24, spec_k=3, rounds=1,
                              device="cpu", log=lambda s: None, keep=keep)
    (base, spec), = keep["outs"]
    assert [o.output_token_ids for o in spec] == [o.output_token_ids for o in base]


def test_method_sweep_tokens_equal_across_methods():
    results = asyncio.run(method_sweep.sweep(("epd", "e_p_d"), num_requests=4, max_tokens=4,
                                             arrival_s=0.05, platform="cpu",
                                             log=lambda s: None))
    assert results["e_p_d"]["layout"] == ["Ex1", "Px1", "Dx1"]
    for r in results.values():
        assert r["all_finished"] and r["tokens_match_epd"], results
