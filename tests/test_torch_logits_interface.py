"""The models' logits interface, parameter counts and the two activations of
the port against the JAX package, on the CPU.

- LlamaForCausalLM.forward_with_logits on tiny-lm and mla-tiny-lm (the JAX
  weights carried over with the weight bridge), f32 activations: a 12-token
  prefill then three decode steps, each step's (cache, tokens, logits)
  within 1e-4 relative of the JAX model's, at none, int8 and int4 weights
  (the quantized ones over the int8 KV cache); the cache is the one passed
  in, updated in place. The JAX MLA cache is 128 lanes wide, the port's
  exactly kv_lora + rope: its first 24 columns are compared.
- forward writes the token table as the JAX model's forward does, and a
  batch that samples every row into the discard slot (-1) leaves the
  one-slot scratch table of forward_with_logits harmless.
- GPT-2's forward_with_logits returns (cache, tokens, logits) and its
  forward a LanguageModelOutput with the same tokens, as JAX's.
- ModelParamsCount equals JAX's elements on tiny-lm and mla-tiny-lm (none,
  int8, int4 packed two a byte, fp8), random:tiny-lm+mm and a tiny Qwen2-VL
  checkpoint, less the JAX layer-scan segments' `offset` scalars (the scan's
  bookkeeping, one a segment, not weights: the port loops in Python).
- param_count() equals JAX's for every ARCH_CONFIGS entry, from shapes alone
  (the port's meta device, JAX's eval_shape).
- gelu_and_mul and new_gelu within 1e-6 of JAX's; PrintOutputTokenProcessor
  logs JAX's line.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import logging

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hydrainfer_tpu.engine import output_token_processor as jax_otp  # noqa: E402
from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxMFC  # noqa: E402
from hydrainfer_tpu.models.factory import getModelFactory as jax_get_factory  # noqa: E402
from hydrainfer_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS  # noqa: E402
from hydrainfer_tpu.models.random_init import RandomWeightFactory as JaxFactory  # noqa: E402
from hydrainfer_tpu.models.random_init import init_decoder_weights  # noqa: E402
from hydrainfer_tpu.ops import activation as jax_act  # noqa: E402
from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxParams  # noqa: E402
from hydrainfer_tpu_torch.engine import output_token_processor as otp  # noqa: E402
from hydrainfer_tpu_torch.models import gpt2  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (LanguageModelBatch,  # noqa: E402
                                                 LanguageModelOutput, ModelFactoryConfig,
                                                 getModelFactory)
from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM  # noqa: E402
from hydrainfer_tpu_torch.models.random_init import (ARCH_CONFIGS,  # noqa: E402
                                                     RandomWeightFactory)
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy  # noqa: E402
from hydrainfer_tpu_torch.ops import activation  # noqa: E402
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams  # noqa: E402

BLOCK = 4
N_BLOCKS = 8
JAX_LANES = 128          # the JAX MLA cache pads the latent dim to a lane multiple
TOL = dict(rtol=1e-4, atol=1e-4)


def port_batch(chunk, n_past, dst=-1):
    T, kv_len = len(chunk), n_past + len(chunk)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    pos = i32(list(range(n_past, kv_len)))
    attn = PagedAttentionParams(
        q_seq_ids=i32([0] * T), q_local_ids=i32(list(range(T))), positions=pos,
        kv_lens=i32([kv_len]), block_tables=i32([list(range(N_BLOCKS))]),
        new_kv_slot_ids=pos, cu_q_lens=i32([0, T]), num_seqs=i32([1]))
    return LanguageModelBatch(token_ids=i32(chunk), positions=pos, attention=attn,
                              sample_token_idx=i32([T - 1]), token_src_slots=i32([-1] * T),
                              sample_dst_slots=i32([dst]))


def jax_batch(chunk, n_past, hidden, dst=-1):
    T, kv_len = len(chunk), n_past + len(chunk)
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    pos = i32(list(range(n_past, kv_len)))
    return JaxBatch(
        token_ids=i32(chunk), positions=pos,
        image_features=jnp.zeros((0, hidden), jnp.float32), image_dst_idx=i32([]),
        attention=JaxParams(q_seq_ids=i32([0] * T), q_local_ids=i32(list(range(T))),
                            positions=pos, kv_lens=i32([kv_len]),
                            block_tables=i32([list(range(N_BLOCKS))]),
                            new_kv_slot_ids=pos, cu_q_lens=i32([0, T]), num_seqs=i32([1])),
        sample_token_idx=i32([T - 1]), token_src_slots=i32([-1] * T),
        sample_dst_slots=i32([dst]))


def models(arch, quant, kv_scale):
    cfg = JAX_ARCHS[arch]
    tree = init_decoder_weights(cfg, jax.random.PRNGKey(0), jnp.float32, quantization=quant)
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    jlm = JaxLlama(tree, cfg, quant, kv_scale=kv_scale)
    lm = LlamaForCausalLM(from_jax_numpy(np_tree, "cpu"), ARCH_CONFIGS[arch], quant,
                          kv_scale=kv_scale)
    return jlm, lm


def caches(cfg, int8: bool):
    """The zeroed JAX and port caches of one sequence."""
    mla = cfg.mla_kv_lora > 0
    planes = 1 if mla else 2 * cfg.n_kv_heads
    shape = (cfg.n_layers, 1, N_BLOCKS + 1, BLOCK, planes, cfg.head_dim)
    dtype = np.int8 if int8 else np.float32
    jshape = shape[:-1] + (JAX_LANES,) if mla else shape
    return jnp.zeros(jshape, dtype), torch.zeros(shape, dtype=torch.int8 if int8
                                                  else torch.float32)


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05), ("int4", 0.05)],
                         ids=["f32", "int8w_int8kv", "int4w_int8kv"])
@pytest.mark.parametrize("arch", ["tiny-lm", "mla-tiny-lm"])
def test_forward_with_logits_matches_jax(arch, quant, kv_scale):
    jlm, lm = models(arch, quant, kv_scale)
    jcache, cache = caches(lm.cfg, kv_scale is not None)
    ids = [int(t) for t in np.random.default_rng(3).integers(3, 200, size=12)]
    hd = lm.cfg.head_dim
    for step in range(4):
        chunk = ids if step == 0 else [ids[-1]]
        n_past = len(ids) - len(chunk)
        jcache, jtok, jlogits = jlm.forward_with_logits(
            jcache, jax_batch(chunk, n_past, lm.cfg.hidden_size), max_q=len(chunk))
        with torch.no_grad():
            out_cache, tok, logits = lm.forward_with_logits(
                cache, port_batch(chunk, n_past), len(chunk))
        assert out_cache is cache and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        assert tok.tolist() == np.asarray(jtok).tolist()
        jc = np.asarray(jcache)[..., :hd]
        if kv_scale is None:
            np.testing.assert_allclose(cache.numpy(), jc, **TOL)
        else:       # int8 rows: a rounding flip at a half step moves one entry by 1
            assert np.abs(cache.numpy().astype(np.int32) - jc).max() <= 1
        ids.append(int(tok[0]))


def test_forward_writes_the_token_table_as_jax():
    jlm, lm = models("tiny-lm", "none", None)
    jcache, cache = caches(lm.cfg, False)
    ids = [5, 17, 9, 44, 3]
    jtable = jnp.zeros((8,), jnp.int32)
    table = torch.zeros(8, dtype=torch.int32)
    jout = jlm.forward(jcache, jtable, jax_batch(ids, 0, lm.cfg.hidden_size, dst=3),
                       max_q=len(ids))
    with torch.no_grad():
        out = lm.forward(cache, table, port_batch(ids, 0, dst=3), len(ids))
    assert isinstance(out, LanguageModelOutput)
    assert out.cache is cache and out.token_table is table
    assert out.sample_token_ids.tolist() == np.asarray(jout.sample_token_ids).tolist()
    assert table.tolist() == np.asarray(jout.token_table).tolist()
    assert int(table[3]) == int(out.sample_token_ids[0])


def test_every_row_sampled_into_the_discard_slot():
    """sample_dst_slots -1 on every row (a batch that samples all its
    positions): the T rows all land in the scratch table's one slot, and
    every row's token is its logits' argmax."""
    _, lm = models("tiny-lm", "none", None)
    _, cache = caches(lm.cfg, False)
    ids = [5, 17, 9, 44, 3, 8]
    T = len(ids)
    batch = port_batch(ids, 0).replace(
        sample_token_idx=torch.arange(T, dtype=torch.int32),
        sample_dst_slots=torch.full((T,), -1, dtype=torch.int32))
    with torch.no_grad():
        _, tok, logits = lm.forward_with_logits(cache, batch, T)
    assert logits.shape == (T, lm.cfg.vocab_size)
    assert tok.tolist() == logits.argmax(-1).tolist()


def test_gpt2_forward_and_three_tuple(tmp_path):
    cfg = transformers.GPT2Config(vocab_size=96, n_positions=64, n_embd=48, n_layer=2,
                                  n_head=4)
    torch.manual_seed(0)
    transformers.GPT2LMHeadModel(cfg).eval().float().save_pretrained(
        tmp_path, safe_serialization=True)
    lm = gpt2.GPT2ModelFactory(ModelFactoryConfig(path=str(tmp_path), dtype="float32"),
                               device="cpu").getLanguageModel()
    ids = [5, 17, 9, 44, 3]
    shape = (2, 1, N_BLOCKS + 1, BLOCK, 8, 12)
    with torch.no_grad():
        cache = torch.zeros(shape)
        out = lm.forward_with_logits(cache, port_batch(ids, 0), len(ids))
        table = torch.zeros(8, dtype=torch.int32)
        fwd = lm.forward(torch.zeros(shape), table, port_batch(ids, 0, dst=2), len(ids))
    assert len(out) == 3 and out[0] is cache
    _, tok, logits = out
    assert tok.tolist() == logits.argmax(-1).tolist()
    assert isinstance(fwd, LanguageModelOutput) and fwd.token_table is table
    assert fwd.sample_token_ids.tolist() == tok.tolist() == [int(table[2])]


# ------------------------------------------------------------ parameter counts

def jax_weight_elements(tree) -> int:
    """JAX's ModelFactory.getModelParamsCount count (its tree_leaves' sizes),
    less the layer-scan segments' `offset` scalars."""
    total = 0
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if getattr(path[-1], "key", None) == "offset":
            assert x.size == 1
            continue
        total += x.size
    return total


def jax_counts(factory):
    vm = getattr(factory.getVisionModel(), "weights", {})
    lm = getattr(factory.getLanguageModel(), "weights", {})
    return jax_weight_elements(vm), jax_weight_elements(lm)


@pytest.mark.parametrize("quant", ["none", "int8", "int4", "fp8"])
@pytest.mark.parametrize("arch", ["tiny-lm", "mla-tiny-lm"])
def test_model_params_count_matches_jax(arch, quant):
    jc = jax_counts(JaxFactory(arch, dtype=jnp.float32, quantization=quant))
    cnt = RandomWeightFactory(arch, dtype=torch.float32, quantization=quant,
                              device="cpu").getModelParamsCount()
    assert (cnt.vision_model_params, cnt.language_model_params) == jc


def test_model_params_count_multimodal_matches_jax():
    name = "random:tiny-lm+mm"
    jc = jax_counts(jax_get_factory(JaxMFC(name=name, dtype="float32")))
    cnt = getModelFactory(ModelFactoryConfig(name=name, dtype="float32"),
                          device="cpu").getModelParamsCount()
    assert jc[0] > 0
    assert (cnt.vision_model_params, cnt.language_model_params) == jc


def test_model_params_count_qwen2_vl_matches_jax(tmp_path):
    from hydrainfer_tpu.models import qwen2_vl as jax_qvl
    from hydrainfer_tpu_torch.models import qwen2_vl
    cfg = transformers.Qwen2VLConfig(
        vision_config=dict(depth=2, embed_dim=64, hidden_size=48, num_heads=4,
                           patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
                           mlp_ratio=2),
        hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=64, max_position_embeddings=256,
        image_token_id=60, vision_start_token_id=61, vision_end_token_id=62,
        rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]})
    torch.manual_seed(0)
    transformers.Qwen2VLForConditionalGeneration(cfg).eval().float().save_pretrained(
        tmp_path, safe_serialization=True)
    jc = jax_counts(jax_qvl.Qwen2VLModelFactory(
        JaxMFC(path=str(tmp_path), dtype="float32", attention_impl="jnp"), None))
    cnt = qwen2_vl.Qwen2VLModelFactory(ModelFactoryConfig(path=str(tmp_path), dtype="fp32"),
                                       device="cpu").getModelParamsCount()
    assert jc[0] > 0 and jc[1] > 0
    assert (cnt.vision_model_params, cnt.language_model_params) == jc


@pytest.mark.parametrize("arch", sorted(ARCH_CONFIGS))
def test_param_count_matches_jax_from_shapes(arch):
    """The logical count at every architecture, full widths included: built
    on the meta device, no weights."""
    assert sorted(ARCH_CONFIGS) == sorted(JAX_ARCHS)
    factory = RandomWeightFactory(arch, quantization="int4", device="meta")
    assert factory.param_count() == JaxFactory(arch).param_count()
    assert factory.getModelParamsCount().language_model_params > 0


# ------------------------------------------------------------ small ops

def test_gelu_and_mul_and_new_gelu_match_jax():
    x = np.random.default_rng(2).standard_normal((6, 32)).astype(np.float32) * 3
    for approximate in (True, False):
        np.testing.assert_allclose(
            activation.gelu_and_mul(torch.from_numpy(x), approximate).numpy(),
            np.asarray(jax_act.gelu_and_mul(jnp.asarray(x), approximate)),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(activation.new_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_act.new_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    lin = torch.linspace(-5, 5, 64).reshape(4, 16)
    assert activation.gelu_and_mul(torch.cat([lin, lin], -1)).shape == lin.shape
    assert activation.new_gelu(lin.bfloat16()).dtype == torch.bfloat16
    assert bool(torch.isfinite(activation.new_gelu(lin)).all())


def test_print_output_token_processor_logs_jax_line(caplog):
    lines = []
    for mod in (jax_otp, otp):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.logger.addHandler(caplog.handler)
            try:
                mod.PrintOutputTokenProcessor().append_token_id(42, is_last_token=True)
            finally:
                mod.logger.removeHandler(caplog.handler)
        lines.append([r.getMessage() for r in caplog.records if "output token" in r.getMessage()])
    assert lines[0] == lines[1] == ["output token 42, last=True"]
