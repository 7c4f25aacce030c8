"""The port's request types against the JAX package's: `TokenParameters`
has JAX's fields, types and defaults, and `Request(token_params=...)` is a
valid call on both (the field is inert in both engines)."""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import dataclasses

import hydrainfer_tpu.request as jax_request
import hydrainfer_tpu_torch.request as port_request


def _spec(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_token_parameters_equal_jax():
    assert _spec(port_request.TokenParameters) == _spec(jax_request.TokenParameters)
    assert (dataclasses.asdict(port_request.TokenParameters())
            == dataclasses.asdict(jax_request.TokenParameters()))


def test_request_takes_token_params_as_jax_does():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]   # noqa: E731
    assert names(port_request.Request) == names(jax_request.Request)
    kw = dict(kv_cache_eviction_policy="streamingllm", window_size=8,
              attention_sink_size=2, token_pruning_policy="focal", n_embed_output_tokens=16)
    port = port_request.Request(prompt="hi", token_params=port_request.TokenParameters(**kw))
    ref = jax_request.Request(prompt="hi", token_params=jax_request.TokenParameters(**kw))
    assert dataclasses.asdict(port.token_params) == dataclasses.asdict(ref.token_params)
    assert port_request.Request().token_params == port_request.TokenParameters()
