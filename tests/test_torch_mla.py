"""The port's MLA path (mla-tiny-lm, single-plane latent cache) against the
JAX package, on the CPU.

- K6's plain version, through its wrapper on CPU tensors, against the JAX
  Pallas layered kernel in its CKV = 1 form (interpret mode), on the cases of
  tests/ops/test_mla_latent_kernel.py:build_latent_case: the five mixed
  prefill/decode batches at 8 heads x D48 (tol 2e-4, f32 sum order), the
  DeepSeek geometry 16 heads x D576 over multi-page contexts (2e-3, the
  tolerance of the JAX test at that width), an int8 plane at scale 0.05
  (2e-3), a 75-page block table and poisoned other layers (2e-4).
- The port's dispatcher over a single-plane cache, all-decode and mixed,
  against the JAX dispatcher (1e-4); the sync-free scatter of the plain
  cache writes against a loop.
- One MLA layer (`_layer_body` vs JAX `_mla_layer`) and one full decoder step
  on mla-tiny-lm with the JAX weights carried over: output rows (1e-4), the
  written latent rows (f32 1e-5; int8 exactly equal), logits and tokens. The
  JAX cache is padded to 128 lanes as its node pads it; the port's is 24 wide
  and is held against the JAX cache's first 24 columns.
- The port's OfflineEngine against the JAX OfflineEngine on mla-tiny-lm (PD):
  chunked prefill (16-token budget), single steps (K=1) and fused windows
  (K=4), f32 and int8 weights + int8 KV: identical greedy tokens.
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
from hydrainfer_tpu.models.decoder import _mla_layer as jax_mla_layer
from hydrainfer_tpu.models.decoder import decoder_forward as jax_decoder_forward
from hydrainfer_tpu.models.factory import unpack_fill_batch as jax_unpack
from hydrainfer_tpu.models.llama import LlamaForCausalLM as JaxLlama
from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxFactory
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.ops.attention import paged_attention as jax_paged_attention
from hydrainfer_tpu.ops.pallas.paged_attention import layered_paged_attention
from hydrainfer_tpu.request import Request as JaxRequest
from hydrainfer_tpu.request import SamplingParameters as JaxSP
from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.engine import executor as port_executor
from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.models.decoder import _layer_body, decoder_forward
from hydrainfer_tpu_torch.models.factory import unpack_fill_batch
from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM
from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS, RandomWeightFactory
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams, paged_attention
from hydrainfer_tpu_torch.ops.cuda import paged_attention_latent
from hydrainfer_tpu_torch.request import Request, SamplingParameters
from tests.ops.test_mla_latent_kernel import build_latent_case
from tests.test_torch_decoder import mixed_batch, table0

SCALE = 0.05
ARCH = "mla-tiny-lm"
JAX_LANES = 128          # the JAX node pads the latent dim to a lane multiple


def t(a):
    return torch.from_numpy(np.array(a))


def port_params(params) -> PagedAttentionParams:
    return PagedAttentionParams(**{f: t(getattr(params, f)) for f in (
        "q_seq_ids", "q_local_ids", "positions", "kv_lens", "block_tables",
        "new_kv_slot_ids", "cu_q_lens", "num_seqs")})


# ------------------------------------------------------------------- K6

K6_CASES = {
    "single_token_prefill": ([(1, 1)], {}),
    "prefill": ([(5, 5)], {}),
    "decode_history": ([(1, 9)], {}),
    "decode_batch": ([(1, 4), (1, 7), (1, 12)], {}),
    "mixed_chunked": ([(6, 6), (1, 9), (3, 11)], {}),
    "deepseek_d576": ([(1, 21), (4, 13), (1, 37)],
                      dict(H=16, D=576, block_size=8, n_blocks=32)),
    "int8_plane": ([(1, 9), (2, 6)], dict(H=4, D=32)),
    "wide_table": ([(4, 300), (1, 270)], dict(n_blocks=160)),     # 75 pages
    "poisoned_layers": ([(2, 6), (1, 9)], dict(L=3)),
}


@pytest.mark.parametrize("name", sorted(K6_CASES))
def test_k6_plain_matches_layered_pallas_kernel(name):
    specs, kw = K6_CASES[name]
    q, cache, params, _ = build_latent_case(np.random.default_rng(11), specs, **kw)
    layer, scale, tol = 0, None, 2e-4
    if name == "poisoned_layers":
        # a wrong-layer read fails loudly
        layer = 1
        cache[0], cache[2] = 1e3, -1e3
    if name == "int8_plane":
        scale, tol = SCALE, 2e-3
        cache = np.clip(np.round(cache / SCALE), -127, 127).astype(np.int8)
    if name == "deepseek_d576":
        tol = 2e-3
    sm = 1.0 / float(np.sqrt(q.shape[-1]))
    ref = layered_paged_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray([layer], jnp.int32),
        params.kv_lens, jnp.maximum(params.block_tables, 0), params.cu_q_lens,
        params.num_seqs, sm_scale=sm, k_scale=scale, v_scale=scale,
        num_kv_pages_per_block=2 if name == "deepseek_d576" else None,
        interpret=True)
    p = port_params(params)
    got = paged_attention_latent(t(q), t(cache)[layer, 0], p.kv_lens,
                                 p.block_tables.clamp(min=0), p.cu_q_lens, p.num_seqs,
                                 sm, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("specs,max_q", [([(1, 4), (1, 7), (1, 12)], 1),
                                         ([(6, 6), (1, 9), (3, 11)], 6)],
                         ids=["all_decode", "mixed"])
def test_dispatcher_on_single_plane_cache_matches_jax(specs, max_q):
    """Every batch over a single-plane cache goes to K6, all-decode
    windows included (K1 assumes combined K/V heads)."""
    q, cache, params, _ = build_latent_case(np.random.default_rng(12), specs)
    sm = 1.0 / np.sqrt(q.shape[-1])
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(cache), 0, params, sm, max_q)
    got = paged_attention(t(q), t(cache), 0, port_params(params), sm, max_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ the MLA layer

def models(quant: str, kv_scale):
    cfg = JAX_ARCHS[ARCH]
    tree = init_decoder_weights(cfg, jax.random.PRNGKey(0), jnp.float32,
                                quantization=quant)
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    jlm = JaxLlama(tree, cfg, quant, kv_scale=kv_scale)
    lm = LlamaForCausalLM(from_jax_numpy(np_tree, "cpu"), ARCH_CONFIGS[ARCH], quant,
                          kv_scale=kv_scale)
    return np_tree, jlm, lm


def latent_caches(cfg, int8: bool, seed: int = 0):
    """The JAX cache (padded to 128 lanes with zeros) and the port's (the
    first head_dim columns): random latent history in every row."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 1, 64, 4, 1, cfg.head_dim)
    if int8:
        c = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        c = rng.standard_normal(shape).astype(np.float32)
    jc = np.zeros(shape[:-1] + (JAX_LANES,), c.dtype)
    jc[..., :cfg.head_dim] = c
    return jc, c


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_mla_layer_matches_jax(quant, kv_scale):
    np_tree, jlm, lm = models(quant, kv_scale)
    flat, jdims, dims = mixed_batch()
    jcache0, cache0 = latent_caches(lm.cfg, kv_scale is not None)
    jbatch = jax_unpack(jnp.asarray(flat), jnp.zeros((1, 1, 1, 1, 1, 1)), jdims,
                        lm.cfg.hidden_size)
    batch = unpack_fill_batch(torch.from_numpy(flat), dims)
    x = np.random.default_rng(5).standard_normal(
        (dims.T, lm.cfg.hidden_size)).astype(np.float32)
    pos = np.asarray(jbatch.positions)
    jx, jcache = jax_mla_layer(
        jnp.asarray(x), jnp.asarray(jcache0), 0,
        jax.tree_util.tree_map(jnp.asarray, np_tree["layers"][0]), jbatch,
        jlm.cos_tab[pos], jlm.sin_tab[pos], jlm.cfg, jdims.max_q)
    cache = t(cache0)
    got = _layer_body(t(x), cache, 0, lm.weights["layers"][0], batch,
                      lm.cos_tab[batch.positions.long()],
                      lm.sin_tab[batch.positions.long()], lm.cfg, dims.max_q)
    n = int(batch.attention.cu_q_lens[-1])          # the real tokens
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(jx)[:n], rtol=1e-4, atol=1e-4)
    jc = np.asarray(jcache)[..., :lm.cfg.head_dim]
    if kv_scale is None:
        np.testing.assert_allclose(cache.numpy(), jc, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(cache.numpy(), jc)
    # the padded lanes stay zero on the JAX side: nothing is lost by the
    # port's exact-width cache
    assert not np.asarray(jcache)[..., lm.cfg.head_dim:].any()


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_mla_decoder_step_matches_jax(quant, kv_scale):
    _, jlm, lm = models(quant, kv_scale)
    flat, jdims, dims = mixed_batch()
    jcache0, cache0 = latent_caches(lm.cfg, kv_scale is not None, seed=1)
    jbatch = jax_unpack(jnp.asarray(flat), jnp.zeros((1, 1, 1, 1, 1, 1)), jdims,
                        lm.cfg.hidden_size)
    jcache, jtt, jtok, jlogits = jax_decoder_forward(
        jlm.weights, jnp.asarray(jcache0), jbatch, jlm.cos_tab, jlm.sin_tab,
        jlm.cfg, jdims.max_q, return_logits=True, token_table=jnp.asarray(table0()))
    cache, tt = t(cache0), torch.from_numpy(table0())
    tok, logits = decoder_forward(lm.weights, cache, unpack_fill_batch(
        torch.from_numpy(flat), dims), lm.cos_tab, lm.sin_tab, lm.cfg, dims.max_q,
        tt, return_logits=True)
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(jlogits)[:3],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tok[:3].numpy(), np.asarray(jtok)[:3])
    np.testing.assert_array_equal(tt[:16].numpy(), np.asarray(jtt)[:16])
    jc = np.asarray(jcache)[..., :lm.cfg.head_dim]
    if kv_scale is None:
        np.testing.assert_allclose(cache.numpy(), jc, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(cache.numpy(), jc)


@pytest.mark.parametrize("slots", [[5, -1, 0, -1, 7], [-1, -1, -1], [3, 0, 9]],
                         ids=["padding_and_slot_0", "all_padding", "no_padding"])
def test_sync_free_scatter_drops_padding(slots):
    """The plain writes' scatter (no nonzero) keeps exactly the rows whose
    slot is >= 0, also when a real row writes slot 0 and when none is real."""
    from hydrainfer_tpu_torch.ops.cuda.kv_writer import scatter_rows
    rng = np.random.default_rng(13)
    flat = torch.from_numpy(rng.standard_normal((12, 1, 6)).astype(np.float32))
    rows = torch.from_numpy(rng.standard_normal((len(slots), 1, 6)).astype(np.float32))
    expect = flat.clone()
    for i, s in enumerate(slots):
        if s >= 0:
            expect[s] = rows[i]
    scatter_rows(flat, torch.tensor(slots, dtype=torch.int32), rows)
    torch.testing.assert_close(flat, expect, rtol=0, atol=0)


def test_rope_tables_take_the_rope_width():
    """init_rope_tables uses rope_head_dim (64 of mla-2b-lm's 576)."""
    from hydrainfer_tpu_torch.models.decoder import init_rope_tables
    cos, sin = init_rope_tables(ARCH_CONFIGS["mla-2b-lm"])
    assert cos.shape == sin.shape == (4096, 32)


# ---------------------------------------------------------------- engines

PROMPTS = ["ab cd ef", "x", "hello world and some more words to chunk",
           "a longer prompt to chunk twice"]
MAX_TOKENS = (12, 6, 12, 10)


def _requests(cls, sp_cls):
    return [cls(request_id=f"r{i}", prompt=p,
                sampling_params=sp_cls(max_tokens=m, ignore_eos=True))
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


_JAX_TOKENS = {}


def jax_tokens(quant: str, kv_scale):
    """The JAX engine's greedy tokens (once per weight mode: greedy tokens do
    not depend on the fused-window length)."""
    if quant not in _JAX_TOKENS:
        factory = JaxFactory(ARCH, dtype=jnp.float32, quantization=quant,
                             kv_scale=kv_scale)
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
        _JAX_TOKENS[quant] = [o.output_token_ids for o in engine.generate(
            _requests(JaxRequest, JaxSP), timeout_s=600)]
    return _JAX_TOKENS[quant]


@pytest.mark.parametrize("k", [1, 4], ids=["K1", "K4"])
@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_port_mla_engine_matches_jax_engine(quant, kv_scale, k, monkeypatch):
    tree = init_decoder_weights(JAX_ARCHS[ARCH], jax.random.PRNGKey(0), jnp.float32,
                                quantization=quant)
    weights = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    windows = []
    orig = port_executor.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    monkeypatch.setattr(port_executor.FillExecutor, "_multi_step_window", spy)
    factory = RandomWeightFactory(ARCH, dtype=torch.float32, quantization=quant,
                                  kv_scale=kv_scale, device="cpu", weights=weights)
    cfg = NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=4),
        request_processor=RequestProcessorConfig(num_request_process_workers=1,
                                                 block_size=4),
        kv_block_size=4, n_kv_blocks=128, multi_step_decode=k)
    engine = OfflineEngine(cfg, model_factory=factory, node_type="PD", device="cpu")
    engine.node.batch_scheduler.token_budget = 16
    cache = engine.node.kv_cache_manager.cache_array
    assert cache.shape[-2:] == (1, 24)
    assert cache.dtype == (torch.int8 if kv_scale is not None else torch.float32)
    got = [o.output_token_ids for o in engine.generate(
        _requests(Request, SamplingParameters), timeout_s=600)]
    assert [len(g) for g in got] == list(MAX_TOKENS)
    assert got == jax_tokens(quant, kv_scale)
    if k > 1:
        assert max(windows) == k, f"no fused K={k} window ran: {sorted(set(windows))}"
    else:
        assert set(windows) == {1}
