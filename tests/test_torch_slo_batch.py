"""The port's last two drivers, slo_run and batch_analysis
(hydrainfer_tpu_torch/evaluation), against the JAX package's `evaluation/`
twins, on the CPU.

- batch_analysis: the analytic decode model, called with the v5e constants
  the JAX script uses, equals the JAX function's dict key for key
  (llava-7b-lm, qwen2-vl-2b-lm, tiny-lm at batches 1, 8, 32, 64); the
  weight-byte formula equals the JAX script's; both `--tiny --model-only`
  tables have the same rows (at the card's constants the port's times
  scale by the ratio of the two rates); the port's `--tiny` measured sweep
  on tiny-lm gives rows with run_bench's keys and tokens/s > 0.
- slo_run: `--tiny --arch tiny-lm --kv-blocks 64` end to end, the port at `--device cpu`
  and the JAX script at `--platform cpu` (one run of it a module): every
  request of both completes with the tokens it asked for and, the port
  serving the JAX script's weights, streams the same text in each of the
  three passes (two warm-up passes, the timed rate); `rate_4.json`
  and `summary.json` carry the same keys (the port's summary adds
  `device`); a trace-arrival run (`--arrival azure`) over a small trace
  file. Without `--device cpu` both drivers raise on a machine with no card.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import asyncio
import importlib
import json
import sys

import numpy as np
import pytest
import torch

import benchmark.benchmark as client
from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS
from hydrainfer_tpu_torch.evaluation import batch_analysis, slo_run
from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS

ARCHS = ("llava-7b-lm", "qwen2-vl-2b-lm", "tiny-lm")
# a 64-block pool for both drivers: the pool formula's 2048 blocks set a
# 512-block table floor, which the plain attention on the CPU walks whole
SLO_TINY = ["--tiny", "--arch", "tiny-lm", "--kv-blocks", "64"]


def _jax(name):
    """A JAX driver module; its import-time setdefault of the JAX
    compile-cache directory is undone."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "")
        return importlib.import_module(f"evaluation.{name}")


def _jax_weight_bytes(cfg) -> int:
    """The weight bytes as the JAX script's main computes them
    (evaluation/batch_analysis.py:87-94)."""
    per_layer = (cfg.hidden_size * (cfg.n_qo_heads + 2 * cfg.n_kv_heads)
                 * cfg.head_dim
                 + cfg.n_qo_heads * cfg.head_dim * cfg.hidden_size
                 + 3 * cfg.hidden_size * cfg.intermediate_size)
    embed = cfg.vocab_size * cfg.hidden_size
    params = cfg.n_layers * per_layer + embed * (1 if cfg.tie_word_embeddings
                                                 else 2)
    return 2 * params


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_bytes_match_jax(arch):
    assert batch_analysis.weight_bytes(ARCH_CONFIGS[arch]) == _jax_weight_bytes(
        JAX_ARCHS[arch])


@pytest.mark.parametrize("batch", [1, 8, 32, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_at_v5e_constants_matches_jax(arch, batch):
    jax_ba = _jax("batch_analysis")
    kv_len = 128 + 64 // 2
    ours = batch_analysis.analytic_decode_model(
        ARCH_CONFIGS[arch], batch, kv_len, batch_analysis.weight_bytes(ARCH_CONFIGS[arch]),
        hbm_bytes_per_s=jax_ba.V5E_HBM_BW, peak_flops=jax_ba.V5E_BF16_FLOPS)
    theirs = jax_ba.analytic_decode_model(JAX_ARCHS[arch], batch, kv_len,
                                          _jax_weight_bytes(JAX_ARCHS[arch]))
    assert ours == theirs


def _main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()
    return capsys.readouterr().out


def _rows(markdown):
    return [line.split("|")[1:-1] for line in markdown.splitlines()
            if line.startswith("| ") and not line.startswith("| batch")]


def test_model_only_tables_have_the_same_rows(monkeypatch, capsys, tmp_path):
    jax_ba = _jax("batch_analysis")
    ours = _main(batch_analysis, ["--tiny", "--model-only", "--out", str(tmp_path / "p.json")],
                 monkeypatch, capsys)
    theirs = _main(jax_ba, ["--tiny", "--model-only", "--out", str(tmp_path / "j.json")],
                   monkeypatch, capsys)
    ours_rows, theirs_rows = _rows(ours), _rows(theirs)
    assert [r[0] for r in ours_rows] == [r[0] for r in theirs_rows] == [" 1 ", " 4 "]
    # batch, bound and compute intensity are the card's no more than the JAX
    # script's; the roofline tokens/s scale by the rate
    assert [(r[0], r[2], r[3]) for r in ours_rows] == [(r[0], r[2], r[3]) for r in theirs_rows]
    port, ref = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "j.json"))
    assert port["arch"] == ref["arch"] and port["measured"] is ref["measured"] is None
    assert port["analytic"].keys() == ref["analytic"].keys()
    ratio = jax_ba.V5E_HBM_BW / batch_analysis.H100_HBM_BW
    for b, row in port["analytic"].items():
        assert row.keys() == ref["analytic"][b].keys()
        assert row["t_mem_ms"] == pytest.approx(ref["analytic"][b]["t_mem_ms"] * ratio,
                                                abs=2e-3)
    # the same rows again at the JAX script's constants
    cfg = ARCH_CONFIGS[port["arch"]]
    for b, row in ref["analytic"].items():
        assert row == batch_analysis.analytic_decode_model(
            cfg, int(b), 16 + 8 // 2, batch_analysis.weight_bytes(cfg),
            hbm_bytes_per_s=jax_ba.V5E_HBM_BW, peak_flops=jax_ba.V5E_BF16_FLOPS)
    assert "~295 flops/byte" in ours and "v5e" not in ours


def test_tiny_measured_sweep_has_run_bench_keys():
    rows = batch_analysis.measured_sweep("tiny-lm", [1, 4], 16, 8, device="cpu")
    assert [r["batch"] for r in rows] == [1, 4]
    for r in rows:
        # the keys the JAX sweep reads out of run_bench
        assert set(r) == {"batch", "tokens_per_s", "vs_roofline", "p50_tbt_s"}
        # (the CPU's share of the card's roofline rounds to 0)
        assert r["tokens_per_s"] > 0 and r["vs_roofline"] >= 0 and r["p50_tbt_s"] > 0


def test_drivers_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(slo_run.amain(slo_run.parse_args(SLO_TINY + ["--out", str(tmp_path)])))
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_analysis.measured_sweep("tiny-lm", [1], 16, 8)


class _Recorder:
    """Wraps the client's run_benchmark and keeps every run's result (the
    drivers import it when they run)."""

    def __init__(self):
        self.results = []
        self.run = client.run_benchmark

    async def __call__(self, *a, **k):
        result = await self.run(*a, **k)
        self.results.append(result)
        return result


@pytest.fixture(scope="module")
def jax_tiny(tmp_path_factory):
    """The JAX script's `--tiny --arch tiny-lm --platform cpu` run: its
    output directory and the BenchmarkResults of its three passes (two
    warm-up passes, then the timed rate)."""
    jax_slo = _jax("slo_run")
    out = tmp_path_factory.mktemp("jax_slo")
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(client, "run_benchmark", rec)
        mp.setattr(sys, "argv", ["slo_run", *SLO_TINY, "--platform", "cpu",
                                 "--out", str(out)])
        jax_slo.main()
    assert len(rec.results) == 3            # two warm-up passes, one rate
    return out, rec.results


def _port_run(argv, factory=None):
    args = slo_run.parse_args(argv)
    return asyncio.run(slo_run.amain(args, factory=factory))


def _jax_weight_factory():
    """The port's tiny-lm factory over the JAX script's weights (its
    factory's bf16 init at PRNGKey(0)), carried over through numpy."""
    import jax
    import jax.numpy as jnp
    from hydrainfer_tpu.models.random_init import init_decoder_weights
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
    tree = init_decoder_weights(JAX_ARCHS["tiny-lm"], jax.random.PRNGKey(0), jnp.bfloat16)
    return RandomWeightFactory("tiny-lm", device="cpu", weights=from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, tree), "cpu"))


def _keys(obj):
    """Every key path of a JSON object."""
    if isinstance(obj, dict):
        return {(k,) + p for k, v in obj.items() for p in _keys(v) | {()}}
    return set()


def _complete(result, entries):
    for o in result.outputs:
        o.finalize()
    return [(o.success, o.total_tokens) for o in result.outputs] == [
        (True, e.max_tokens) for e in entries]


def test_slo_run_tiny_matches_jax(jax_tiny, tmp_path):
    jax_out, jax_results = jax_tiny
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(client, "run_benchmark", rec)
        report = _port_run(SLO_TINY + ["--device", "cpu", "--out", str(tmp_path)],
                           factory=_jax_weight_factory())
    entries = report["entries"]
    assert len(entries) == 6
    assert len(rec.results) == 3 and rec.results[-1] is report["results"][4]
    # every request of both runs completes with the tokens it asked for, and
    # over the same weights the text each request streamed is the same, in
    # each warm-up pass and in the timed rate
    for ours, theirs in zip(rec.results, jax_results):
        assert _complete(ours, entries)
        assert _complete(theirs, entries)
        assert [o.output_text for o in ours.outputs] == [
            o.output_text for o in theirs.outputs]
    assert all(o.output_text for o in rec.results[-1].outputs)
    ours = json.loads((tmp_path / "rate_4.json").read_text())
    theirs = json.loads((jax_out / "rate_4.json").read_text())
    assert _keys(ours) == _keys(theirs)
    assert ours["n_success"] == theirs["n_success"] == 6
    assert ours["total_output_tokens"] == theirs["total_output_tokens"] == sum(
        e.max_tokens for e in entries)
    summary = json.loads((tmp_path / "summary.json").read_text())
    ref = json.loads((jax_out / "summary.json").read_text())
    assert summary.pop("device") == "cpu"
    assert _keys(summary) == _keys(ref)
    assert {k: summary[k] for k in ("arch", "ttft_slo", "tpot_slo", "arrival", "quant",
                                    "kv_int8", "entries")} == {
        k: ref[k] for k in ("arch", "ttft_slo", "tpot_slo", "arrival", "quant", "kv_int8",
                            "entries")}
    assert [r["request_rate"] for r in summary["table"]] == [4]
    # the timed sweep's metrics, before and after, from the one node
    assert list(report["sweep_metrics"]["after"]) == ["PDNode:pd0"]


def test_slo_run_replays_an_azure_trace(tmp_path):
    trace = tmp_path / "azure.csv"
    stamps = ["2023-11-16 18:15:46.680590", "2023-11-16 18:15:46.700000",
              "2023-11-16 18:15:47.100000", "2023-11-16 18:15:47.110000",
              "2023-11-16 18:15:48.500000", "2023-11-16 18:15:48.900000"]
    trace.write_text("TIMESTAMP,ContextTokens,GeneratedTokens\n"
                     + "".join(f"{s},100,20\n" for s in stamps))
    out = tmp_path / "out"
    report = _port_run(SLO_TINY + ["--device", "cpu", "--arrival", "azure",
                                   "--trace-path", str(trace), "--gap-slo", "0.5",
                                   "--out", str(out)])
    assert _complete(report["results"][4], report["entries"])
    summary = json.loads((out / "summary.json").read_text())
    assert summary["arrival"] == "azure" and summary["trace_path"] == str(trace)
    assert summary["strict"][0].keys() == {"0.5"}
    assert json.loads((out / "rate_4.json").read_text())["slo_strict"]["0.5"][
        "request_rate"] == 4
