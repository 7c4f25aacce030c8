"""`WeightStore.keys` / `assert_consumed` against the JAX package's: a tiny
safetensors checkpoint with one tensor that no converter reads is named in a
warning by both stores, and by both text-only factories when they load a
tiny Llama checkpoint that carries an extra tensor."""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import logging
import os

import numpy as np
import pytest
import torch

safetensors_numpy = pytest.importorskip("safetensors.numpy")
transformers = pytest.importorskip("transformers")

from hydrainfer_tpu.models import weight_loader as jax_loader  # noqa: E402
from hydrainfer_tpu.models.factory import ModelFactoryConfig as JaxConfig  # noqa: E402
from hydrainfer_tpu.models.text_only import TextOnlyModelFactory as JaxTextOnly  # noqa: E402
from hydrainfer_tpu_torch.models import weight_loader as port_loader  # noqa: E402
from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig  # noqa: E402
from hydrainfer_tpu_torch.models.text_only import TextOnlyModelFactory  # noqa: E402


class _Warnings(logging.Handler):
    """Collects one logger's warnings (the packages' loggers do not
    propagate, so caplog does not see them)."""

    def __init__(self, logger):
        super().__init__(logging.WARNING)
        self.logger, self.messages = logger, []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def _unconsumed(store_module, make_store, read):
    store = make_store()
    for name in read:
        store.get_np(name)
    with _Warnings(store_module.logger) as w:
        store.assert_consumed()
    return store, w.messages


def test_assert_consumed_names_the_extra_tensor_like_jax(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a.weight": rng.standard_normal((4, 3)).astype(np.float32),
               "b.bias": rng.standard_normal(3).astype(np.float32),
               "extra.unused": rng.standard_normal(2).astype(np.float32)}
    safetensors_numpy.save_file(tensors, str(tmp_path / "model.safetensors"))
    port, port_msgs = _unconsumed(
        port_loader, lambda: port_loader.WeightStore(str(tmp_path), device="cpu"),
        ["a.weight", "b.bias"])
    ref, ref_msgs = _unconsumed(jax_loader, lambda: jax_loader.WeightStore(str(tmp_path)),
                                ["a.weight", "b.bias"])
    assert sorted(port.keys()) == sorted(ref.keys()) == sorted(tensors)
    assert port_msgs == ref_msgs
    assert len(port_msgs) == 1 and "extra.unused" in port_msgs[0]
    assert "a.weight" not in port_msgs[0] and "b.bias" not in port_msgs[0]
    # an ignored prefix, and a store read whole, warn in neither package
    for module, make in ((port_loader, lambda: port_loader.WeightStore(str(tmp_path),
                                                                       device="cpu")),
                         (jax_loader, lambda: jax_loader.WeightStore(str(tmp_path)))):
        store = make()
        for name in ("a.weight", "b.bias"):
            store.get_np(name)
        with _Warnings(module.logger) as w:
            store.assert_consumed(ignore_prefixes=("extra.",))
        assert w.messages == []
        store.get(("extra.unused"))
        with _Warnings(module.logger) as w:
            store.assert_consumed()
        assert w.messages == []


def test_text_only_factories_warn_on_an_extra_checkpoint_tensor(tmp_path):
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).save_pretrained(tmp_path, safe_serialization=True)
    safetensors_numpy.save_file({"model.layers.0.self_attn.misnamed.weight":
                                 np.zeros((2, 2), np.float32)},
                                os.path.join(tmp_path, "extra.safetensors"))
    with _Warnings(port_loader.logger) as port:
        TextOnlyModelFactory(ModelFactoryConfig(path=str(tmp_path), dtype="float32"),
                             device="cpu").getLanguageModel()
    with _Warnings(jax_loader.logger) as ref:
        JaxTextOnly(JaxConfig(path=str(tmp_path), dtype="float32"), None).getLanguageModel()
    assert len(port.messages) == 1 and port.messages == ref.messages
    assert "model.layers.0.self_attn.misnamed.weight" in port.messages[0]
