"""The port's native host packer (hydrainfer_tpu_torch/csrc/hostops.cpp,
built at first use by engine/hostops.py) against its oracles, on the CPU.

Over random fill batches across the T / S / MB / Ti buckets (prefills,
resolved and unresolved decodes, chunk heads without a sample destination,
image prefills, high-water floors), the buffer the engine packs natively
equals, bit for bit, both the port's Python packer (`_build_python`) on the
same batch and the JAX package's `hydrainfer_tpu._C.hostops.pack_fill_batch`
on the same per-sequence tuples. A batch with a non-contiguous request takes
the Python packer, and a packer that fails to build raises with the
compiler's output instead of falling back.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest

from hydrainfer_tpu._C import hostops as jax_hostops
from hydrainfer_tpu_torch.engine import hostops
from hydrainfer_tpu_torch.engine.isa import ImageEmbedFill, TextFill
from hydrainfer_tpu_torch.engine.params_builder import LanguageModelBatchBuilder
from hydrainfer_tpu_torch.engine.rcb import RequestControlBlock
from hydrainfer_tpu_torch.memory import (TokenCacheBlockManager,
                                         TokenCacheBlockManagerConfig)
from hydrainfer_tpu_torch.models.factory import fill_sizes
from hydrainfer_tpu_torch.request import SamplingParameters

BLOCK = 4


def _managers():
    kv = TokenCacheBlockManager(TokenCacheBlockManagerConfig(
        n_layers=1, n_tensors=1, n_blocks=16384, block_size=BLOCK, n_heads=4, head_dim=8,
        dtype="fp32"), "cpu")
    img = TokenCacheBlockManager(TokenCacheBlockManagerConfig(
        n_layers=1, n_tensors=1, n_blocks=512, block_size=8, n_heads=2, head_dim=16,
        dtype="fp32"), "cpu")
    return kv, img


def _random_batch(rng, kv, img, max_seqs, max_prefill, max_ctx, images, mrope):
    """A builder over a random mix of prefills, decodes (resolved and not),
    chunk heads and (with `images`) image prefills, and the caches to free."""
    builder = LanguageModelBatchBuilder(kv, img, mrope)
    dummy = TextFill([-1], [0], [0], True, None, None)
    held = []
    for slot in range(int(rng.integers(1, max_seqs + 1))):
        rcb = RequestControlBlock()
        rcb.sampling_params = SamplingParameters(max_tokens=8)
        rcb.token_slot = slot
        rcb.virtual_kv_cache = kv.allocate_virtual_cache()
        held.append((kv, rcb.virtual_kv_cache))
        kind = int(rng.integers(0, 5 if images else 4))
        if kind in (0, 3, 4):           # prefill, chunk head, image prefill
            n = int(rng.integers(2 if kind == 4 else 1, max_prefill + 1))
            start = int(rng.integers(0, max_ctx)) if kind == 3 else 0
            kv.realloc(rcb.virtual_kv_cache, start + n)
            toks = [int(t) for t in rng.integers(0, 90, n)]
            pos = list(range(start, start + n))
            dst = None if kind == 3 else dummy
            if kind == 4:
                mask = [bool(m) for m in rng.integers(0, 2, n)]
                mask[0] = True
                n_img = sum(mask)
                rcb.virtual_image_cache = img.allocate_virtual_cache()
                img.realloc(rcb.virtual_image_cache, n_img)
                held.append((img, rcb.virtual_image_cache))
                inst = ImageEmbedFill(list(range(n_img)), mask, toks, pos, list(pos), True,
                                      dst, None)
            else:
                inst = TextFill(toks, pos, list(pos), True, dst, None)
        else:                           # a decode; token unresolved half the time
            ctx = int(rng.integers(2, max_ctx + 1))
            kv.realloc(rcb.virtual_kv_cache, ctx)
            tok = -1 if kind == 2 else int(rng.integers(0, 90))
            inst = TextFill([tok], [ctx - 1], [ctx - 1], True,
                            dummy if rng.integers(0, 4) else None, None)
        if mrope:
            inst.mrope_hw = [[p + 1 for p in inst.position_ids],
                             [2 * p for p in inst.position_ids]]
        builder.add(rcb, inst)
    return builder, held


# (max sequences, longest prefill, longest context, images, M-RoPE, floors):
# together the cases meet T 8-2048, S 1-64, MB 1-256 and Ti 0-512
CASES = {
    "decode_small": (4, 1, 40, False, False, (1, 1, 0)),
    "mixed_s16": (16, 60, 200, False, False, (1, 1, 0)),
    "mixed_s64_floors": (48, 40, 1000, False, False, (64, 128, 0)),
    "long_prefill": (6, 700, 300, False, False, (8, 64, 0)),
    "images": (12, 120, 300, True, False, (1, 1, 0)),
    "images_ti_floor": (24, 90, 400, True, False, (32, 32, 512)),
    "images_mrope": (10, 100, 200, True, True, (4, 16, 64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_pack_equals_python_and_jax(case):
    max_seqs, max_prefill, max_ctx, images, mrope, floors = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    kv, img = _managers()
    seen = set()
    for trial in range(6):
        builder, held = _random_batch(rng, kv, img, max_seqs, max_prefill, max_ctx,
                                      images, mrope)
        assert builder._contiguous
        plan = builder.build(*floors)       # the engine's path: native
        d = plan.dims
        seen.add((d.T, d.S, d.MB, d.Ti))
        python = builder._build_python(d)
        assert plan.flat.dtype == np.int32 and python.dtype == np.int32
        np.testing.assert_array_equal(plan.flat, python, err_msg=f"{case} trial {trial}")
        # the JAX package's extension on the same tuples (its core fields)
        core = sum(fill_sizes(d)[:14])
        jax_flat = np.empty(core, np.int32)
        jax_hostops.pack_fill_batch(jax_flat, d.T, d.S, d.MB, d.Ti, BLOCK,
                                    builder.native_seqs(), builder.image_slot_ids,
                                    builder.image_dst_idx)
        np.testing.assert_array_equal(plan.flat[:core], jax_flat,
                                      err_msg=f"{case} trial {trial} vs JAX")
        for mgr, vc in held:
            mgr.realloc(vc, 0)
    assert len(seen) > 1, "the trials met one bucket only"


def test_non_contiguous_batch_takes_the_python_packer(monkeypatch):
    kv, img = _managers()
    builder = LanguageModelBatchBuilder(kv, img)
    rcb = RequestControlBlock()
    rcb.sampling_params = SamplingParameters(max_tokens=8)
    rcb.token_slot = 0
    rcb.virtual_kv_cache = kv.allocate_virtual_cache()
    kv.realloc(rcb.virtual_kv_cache, 12)
    # cache slots 0-3 then 8-11: not one run
    builder.add(rcb, TextFill(list(range(8)), list(range(8)), [0, 1, 2, 3, 8, 9, 10, 11],
                              True, None, None))
    assert not builder._contiguous

    def refuse(*a, **k):
        raise AssertionError("the native packer packed a non-contiguous batch")
    monkeypatch.setattr(hostops, "load", refuse)
    plan = builder.build()
    np.testing.assert_array_equal(plan.flat, builder._build_python(plan.dims))
    slots = plan.flat[4 * plan.dims.T:5 * plan.dims.T][:8]
    table = rcb.virtual_kv_cache.block_table
    want = [table[c // BLOCK] * BLOCK + c % BLOCK for c in (0, 1, 2, 3, 8, 9, 10, 11)]
    assert slots.tolist() == want


def test_failed_build_raises_without_fallback(monkeypatch, tmp_path):
    bad = tmp_path / "hostops.cpp"
    bad.write_text("#include <Python.h>\nthis is not C++;\n")
    monkeypatch.setattr(hostops, "SOURCE", bad)
    monkeypatch.setattr(hostops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hostops, "_module", None)
    with pytest.raises(RuntimeError, match="native host packer build failed"):
        hostops.load()
    kv, img = _managers()
    builder = LanguageModelBatchBuilder(kv, img)
    rcb = RequestControlBlock()
    rcb.sampling_params = SamplingParameters(max_tokens=8)
    rcb.token_slot = 0
    rcb.virtual_kv_cache = kv.allocate_virtual_cache()
    kv.realloc(rcb.virtual_kv_cache, 3)
    builder.add(rcb, TextFill([1, 2, 3], [0, 1, 2], [0, 1, 2], True, None, None))
    with pytest.raises(RuntimeError, match="this is not C"):
        builder.build()
    assert not list((tmp_path / "build").glob("*.so")), "a failed build left a library"


def test_build_is_cached_by_source_hash():
    first = hostops.build()
    assert first.exists() and first.parent == hostops.BUILD_DIR
    assert hostops.build() == first and hostops.build_seconds == 0.0
    assert hostops.load().pack_fill_batch is not None


def test_packer_refuses_what_would_write_out_of_bounds():
    mod = hostops.load()
    flat = np.zeros(6 * 8 + 3 * 1 + 1 * 2 + 2 + 1, np.int32)
    with pytest.raises(ValueError, match="overflows"):
        mod.pack_fill_batch(flat, 8, 1, 2, 0, BLOCK,
                            [([1] * 9, 0, 9, 0, 9, -1, [0, 1, 2], 0)], [], [])
    with pytest.raises(ValueError, match="outside"):      # slot 8 needs a third block
        mod.pack_fill_batch(flat, 8, 1, 2, 0, BLOCK,
                            [([1] * 2, 7, 2, 0, 9, -1, [0, 1], 7)], [], [])
    with pytest.raises(ValueError, match="need"):
        mod.pack_fill_batch(np.zeros(3, np.int32), 8, 1, 2, 0, BLOCK, [], [], [])
    with pytest.raises(ValueError, match="block_size"):
        mod.pack_fill_batch(flat, 8, 1, 2, 0, 0, [], [], [])
