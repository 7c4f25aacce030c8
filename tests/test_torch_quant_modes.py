"""int4 and fp8 weight quantization: the port (hydrainfer_tpu_torch/ops/quant.py) against JAX.

The same seeded numpy arrays go through hydrainfer_tpu/ops/quant.py and its
port. The quantize functions give byte-equal values and equal scales at input
dims that select each group of the int4 halving chain (g = 128 at 256, 64 at
704, 32 at 96, per column at 130) and for fp8 per column and at group 128;
int8's scales are JAX's bit for bit too (both take amax times the f32
reciprocal of 127, as XLA folds JAX's division). dequantize is equal;
qmatmul and qmatmul_f32 (on the CPU: the K4 forms' plain versions) match in
f32 within 1e-5 relative and in bf16 within one bf16 step of the largest
output (2^-8 relative: the sums' order differs, then the output is rounded).
A JAX-quantized tiny-lm tree bridges to leaves equal to the port's own
quantization of the same f32 tree. The port's OfflineEngine gives the JAX
engine's greedy tokens on tiny-lm and mla-tiny-lm at both modes, f32 and
int8 KV, fused windows K = 1 and 4. The round trips and the tree layout
mirror tests/ops/test_quant.py.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.cluster.node import NodeConfig as JaxNodeConfig
from hydrainfer_tpu.engine.request_processor import \
    RequestProcessorConfig as JaxRPConfig
from hydrainfer_tpu.engine.scheduler import BatchSchedulerConfig as JaxBSConfig
from hydrainfer_tpu.entrypoint.offline import OfflineEngine as JaxOfflineEngine
from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxFactory
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.ops import quant as jq
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine import executor as port_executor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.ops import quant as tq
from hydrainfer_tpu_torch.ops.cuda.quant_matmul import unpack_int4
from hydrainfer_tpu_torch.request import Request, SamplingParameters

FMTS = {"int8": (jq.quantize_int8, tq.quantize_int8),
        "int4": (jq.quantize_int4, tq.quantize_int4),
        "fp8": (jq.quantize_fp8, tq.quantize_fp8)}


def _w(K, N, seed=0):
    w = (np.random.default_rng(seed).standard_normal((K, N)) * 0.02).astype(np.float32)
    w[1, 0] = 3e-7              # an e4m3 subnormal after scaling
    w[2, :] = 0.0               # a zero row
    return w


def _both(fmt, w, group=None):
    jf, tf = FMTS[fmt]
    kw = {} if group is None else {"group": group}
    return jf(jnp.asarray(w), **kw), tf(torch.from_numpy(w), **kw)


def _bytes(a) -> np.ndarray:
    a = np.asarray(a.view(torch.uint8) if isinstance(a, torch.Tensor) else a)
    return a.view(np.uint8)


# (fmt, input dim, group asked for, group expected): the int4 halving chain
# (128 at 256, 64 at 704, 32 at 96, per column at 130: an even dim with no
# group), fp8 per column and at group 128, int8
CASES = [("int4", 256, None, 128), ("int4", 704, None, 64), ("int4", 96, None, 32),
         ("int4", 130, None, 0), ("fp8", 256, None, 0), ("fp8", 704, None, 0),
         ("fp8", 256, 128, 128), ("fp8", 704, 128, 64), ("int8", 704, None, 0)]
IDS = [f"{f}_{k}_g{g}" for f, k, _, g in CASES]


@pytest.mark.parametrize("fmt,K,group,expect", CASES, ids=IDS)
def test_quantize_is_byte_equal_to_jax(fmt, K, group, expect):
    jt, tt = _both(fmt, _w(K, 40), group)
    assert (jt.bits, jt.fmt, jt.group) == (tt.bits, tt.fmt, tt.group)
    assert tt.group == expect
    assert tt.q.shape == tuple(jt.q.shape) and tt.scale.shape == tuple(jt.scale.shape)
    np.testing.assert_array_equal(_bytes(tt.q), _bytes(jt.q))
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt,K,group,expect", CASES, ids=IDS)
def test_dequantize_and_qmatmul_match_jax(fmt, K, group, expect, dtype):
    jt, tt = _both(fmt, _w(K, 40), group)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    np.testing.assert_array_equal(
        tq.dequantize(tt, tdt).float().numpy(),
        np.asarray(jq.dequantize(jt, jdt).astype(jnp.float32)))
    x = np.random.default_rng(K).standard_normal((5, K)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    for jfn, tfn in ((jq.qmatmul, tq.qmatmul), (jq.qmatmul_f32, tq.qmatmul_f32)):
        ref = np.asarray(jfn(jx, jt).astype(jnp.float32))
        got = tfn(tx, tt).float().numpy()
        top = np.abs(ref).max()
        out_bf16 = dtype == "bf16" and jfn is jq.qmatmul
        np.testing.assert_allclose(got, ref, rtol=0, atol=(2 ** -8 if out_bf16 else 1e-5) * top)


def test_int4_pack_unpack_roundtrip():
    w = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)
    qt = tq.quantize_int4(torch.from_numpy(w))
    assert qt.q.shape == (32, 16) and qt.q.dtype == torch.int8 and qt.bits == 4
    deq = tq.dequantize(qt, torch.float32).numpy()
    assert np.abs(deq - w).max() <= (np.abs(w).max(0) / 7.0).max() * 0.51 + 1e-6
    # the nibbles: row 2i low, 2i + 1 high, two's complement in [-7, 7]
    q = np.clip(np.round(w.reshape(2, 32, 16) / qt.scale.numpy()[:, None, :]), -7, 7)
    np.testing.assert_array_equal(unpack_int4(qt.q).numpy(), q.reshape(64, 16))


def test_fp8_roundtrip_error():
    w = np.random.default_rng(4).standard_normal((64, 32)).astype(np.float32)
    qt = tq.quantize_fp8(torch.from_numpy(w))
    assert qt.q.dtype == torch.float8_e4m3fn and qt.fmt == "fp8" and qt.group == 0
    deq = tq.dequantize(qt, torch.float32).numpy()
    assert np.abs(deq - w).max() <= np.abs(w).max() * (2 ** -4) + 1e-6


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_qmatmul_close_to_full_precision(fmt):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    exact = (x @ w).numpy()
    qt = FMTS[fmt][1](w)
    approx = tq.qmatmul(x, qt).numpy()
    rel = np.abs(approx - exact).max() / np.abs(exact).max()
    assert rel < {"int8": 0.02, "fp8": 0.05, "int4": 0.15}[fmt]
    np.testing.assert_allclose(tq.qmatmul_f32(x, qt).numpy(), approx, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("mode", ["int4", "fp8"])
def test_quantize_tree_layout(mode):
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    weights = {"embed": mk(100, 16),
               "layers": [{"qkv_proj": mk(16, 48), "o_proj": mk(16, 16),
                           "gate_up": mk(16, 64), "down": mk(32, 16), "input_norm": mk(16),
                           "post_norm": mk(16), "moe_gate_up": mk(2, 16, 8)}
                          for _ in range(2)],
               "norm": mk(16), "lm_head": mk(16, 100)}
    q = tq.quantize_tree(weights, mode)
    layer = q["layers"][0]
    for key in ("qkv_proj", "o_proj", "gate_up", "down"):
        assert isinstance(layer[key], tq.QuantizedTensor)
        assert (layer[key].bits, layer[key].fmt) == ((4, "int") if mode == "int4" else (8, "fp8"))
    # int4 keeps the lm_head at int8; fp8 quantizes it as fp8
    head = q["lm_head"]
    assert (head.bits, head.fmt) == ((8, "int") if mode == "int4" else (8, "fp8"))
    for key in ("input_norm", "moe_gate_up"):
        assert not isinstance(layer[key], tq.QuantizedTensor)
    assert not isinstance(q["embed"], tq.QuantizedTensor)
    assert tq.quantize_tree(q, mode)["layers"][0]["down"] is layer["down"]      # idempotent
    assert tq.quantize_tree(weights, "none") is weights
    with pytest.raises(ValueError, match="unknown quantization"):
        tq.quantize_tree(weights, "int3")


@pytest.mark.parametrize("mode", ["int4", "fp8"])
def test_jax_quantized_tree_bridges_to_the_ports_own(mode):
    """init_decoder_weights(tiny-lm) quantized by JAX and bridged over equals
    the port's quantize_tree of the same f32 tree, leaf for leaf, bit for
    bit (fp8 arrives as ml_dtypes float8_e4m3fn)."""
    cfg, key = JAX_ARCHS["tiny-lm"], jax.random.PRNGKey(0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    got = from_jax_numpy(to_np(init_decoder_weights(cfg, key, jnp.float32,
                                                    quantization=mode)), "cpu")
    ref = tq.quantize_tree(from_jax_numpy(to_np(init_decoder_weights(cfg, key, jnp.float32)),
                                          "cpu"), mode)
    pairs = [(got["lm_head"], ref["lm_head"])] + [
        (g[k], r[k]) for g, r in zip(got["layers"], ref["layers"]) for k in r]
    n_quant = 0
    for a, b in pairs:
        if isinstance(b, tq.QuantizedTensor):
            n_quant += 1
            assert isinstance(a, tq.QuantizedTensor)
            assert (a.bits, a.fmt, a.group) == (b.bits, b.fmt, b.group)
            assert a.q.dtype == b.q.dtype
            np.testing.assert_array_equal(_bytes(a.q), _bytes(b.q))
            assert torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)
    assert n_quant == 1 + 4 * cfg.n_layers


# ---------------------------------------------------------------- engines

PROMPTS = ["ab cd ef", "x", "hello world and some more words to chunk",
           "a longer prompt to chunk twice"]
MAX_TOKENS = (10, 5, 10, 8)
_JAX_TOKENS = {}


def _requests(cls, sp_cls):
    return [cls(request_id=f"r{i}", prompt=p,
                sampling_params=sp_cls(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


def _jax_tokens(arch, quant, kv_scale):
    """The JAX engine's greedy tokens (once per model and mode: they do not
    depend on the fused-window length)."""
    key = (arch, quant, kv_scale)
    if key not in _JAX_TOKENS:
        factory = JaxFactory(arch, dtype=jnp.float32, quantization=quant, kv_scale=kv_scale)
        cfg = JaxNodeConfig(
            batch_scheduler=JaxBSConfig(max_running_requests=4, priority="prefill"),
            request_processor=JaxRPConfig(num_request_process_workers=1, block_size=4),
            kv_block_size=4, n_kv_blocks=128, n_image_blocks=1, multi_step_decode=4,
            spec_ngram_k=0)
        cfg.model.dtype = "float32"
        if kv_scale is not None:
            cfg.model.kv_cache_dtype = "int8"
        engine = JaxOfflineEngine(cfg, model_factory=factory, node_type="PD")
        engine.node.batch_scheduler.token_budget = 16
        _JAX_TOKENS[key] = [o.output_token_ids for o in engine.generate(
            _requests(JaxRequest, JaxSP), timeout_s=600)]
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("k", [1, 4], ids=["K1", "K4"])
@pytest.mark.parametrize("kv_scale", [None, 0.05], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("quant", ["int4", "fp8"])
@pytest.mark.parametrize("arch", ["tiny-lm", "mla-tiny-lm"])
def test_port_engine_matches_jax_engine(arch, quant, kv_scale, k, monkeypatch):
    """The JAX random init quantized by JAX, carried over, served by the
    port's OfflineEngine: the JAX engine's greedy tokens."""
    tree = init_decoder_weights(JAX_ARCHS[arch], jax.random.PRNGKey(0), jnp.float32,
                                quantization=quant)
    weights = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    layer = weights["layers"][0]
    assert isinstance(layer["down"], tq.QuantizedTensor)
    assert layer["down"].bits == (4 if quant == "int4" else 8)
    windows = []
    orig = port_executor.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    monkeypatch.setattr(port_executor.FillExecutor, "_multi_step_window", spy)
    factory = RandomWeightFactory(arch, dtype=torch.float32, quantization=quant,
                                  kv_scale=kv_scale, device="cpu", weights=weights)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=4),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, multi_step_decode=k, spec_ngram_k=0)
    engine = OfflineEngine(cfg, model_factory=factory, node_type="PD", device="cpu")
    engine.node.batch_scheduler.token_budget = 16
    got = [o.output_token_ids for o in engine.generate(
        _requests(Request, SamplingParameters), timeout_s=600)]
    assert [len(g) for g in got] == list(MAX_TOKENS)
    assert got == _jax_tokens(arch, quant, kv_scale)
    assert (max(windows) == k) if k > 1 else set(windows) == {1}


@pytest.mark.parametrize("quant", ["int4", "fp8"])
def test_random_weight_factory_quantizes_layer_by_layer(quant):
    """RandomWeightFactory at int4 / fp8 builds the tree JAX's quantize_tree
    layout gives (int4: its lm_head int8), and param_bytes counts the packed
    values and every scale."""
    from hydrainfer_tpu_torch.models.random_init import (ARCH_CONFIGS, quant_matmul_forms,
                                                         quant_weight_bytes)
    factory = RandomWeightFactory("tiny-lm", dtype=torch.float32, quantization=quant,
                                  device="cpu")
    w = factory.getLanguageModel().weights
    cfg = ARCH_CONFIGS["tiny-lm"]
    forms = quant_matmul_forms(cfg, quant)
    keys = {"qkv": "qkv_proj", "o": "o_proj", "gate_up": "gate_up", "down": "down"}
    for name, (K, N, fmt, group) in forms.items():
        leaf = w["lm_head"] if name == "lm_head" else w["layers"][0][keys[name]]
        assert tq._fmt(leaf) == fmt and leaf.group == group
        assert leaf.q.numel() * leaf.q.element_size() + leaf.scale.numel() * 4 == \
            quant_weight_bytes(K, N, fmt, group)
    assert forms["lm_head"][2] == ("int8" if quant == "int4" else "fp8")
