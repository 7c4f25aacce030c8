"""The port's model downloader against the JAX package's, offline only
(nothing here sets HYDRAINFER_ALLOW_DOWNLOAD or reaches the network): the
guard refuses while downloads are disabled, `convert_pickle_to_safetensors`
writes the same files as the JAX function from a directory of torch.save'd
tensors, `ensure_local_model` passes a local directory through, and
`getModelFactory` keeps a clear error for a path that is not one."""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import os

import numpy as np
import pytest
import torch

safetensors_numpy = pytest.importorskip("safetensors.numpy")

from hydrainfer_tpu.models import downloader as jax_downloader  # noqa: E402
from hydrainfer_tpu_torch.models import downloader  # noqa: E402
from hydrainfer_tpu_torch.models.factory import (ModelFactoryConfig,  # noqa: E402
                                                 getModelFactory)


@pytest.fixture(autouse=True)
def no_downloads(monkeypatch):
    monkeypatch.delenv("HYDRAINFER_ALLOW_DOWNLOAD", raising=False)


@pytest.mark.parametrize("module", [downloader, jax_downloader], ids=["port", "jax"])
def test_guard_refuses_while_downloads_are_disabled(module):
    assert not module.downloads_enabled()
    assert module.downloads_enabled(True) and not module.downloads_enabled(False)
    with pytest.raises(RuntimeError, match="downloads are disabled"):
        module.download_hf_model("org/name")
    with pytest.raises(RuntimeError, match="downloads are disabled"):
        module.download_hf_model("org/name", allow_download=False)
    # a repo id without downloads comes back unchanged, as does an absolute path
    assert module.ensure_local_model("org/name") == "org/name"
    assert module.ensure_local_model("/no/such/dir") == "/no/such/dir"


def _pickles(path):
    g = torch.Generator().manual_seed(0)
    os.makedirs(path)
    torch.save({"w": torch.randn(4, 3, generator=g), "b": torch.randn(3, generator=g)},
               os.path.join(path, "pytorch_model.bin"))
    shared = torch.randn(6, generator=g)
    torch.save({"x": shared[:3], "y": shared[3:]}, os.path.join(path, "shard.pth"))
    torch.save({"n": 3}, os.path.join(path, "not_tensors.bin"))
    torch.save(torch.nn.Linear(2, 2), os.path.join(path, "module.pth"))   # not weights-only
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write("{}")


def test_convert_pickle_to_safetensors_writes_what_jax_writes(tmp_path):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _pickles(port_dir)
    _pickles(jax_dir)
    downloader.convert_pickle_to_safetensors(port_dir)
    jax_downloader.convert_pickle_to_safetensors(jax_dir)
    port_files = sorted(f for f in os.listdir(port_dir) if f.endswith(".safetensors"))
    assert port_files == sorted(f for f in os.listdir(jax_dir) if f.endswith(".safetensors"))
    assert port_files == ["pytorch_model.safetensors", "shard.safetensors"]
    for name in port_files:
        a = safetensors_numpy.load_file(os.path.join(port_dir, name))
        b = safetensors_numpy.load_file(os.path.join(jax_dir, name))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # converted files are skipped on a second pass
    stamp = os.path.getmtime(os.path.join(port_dir, port_files[0]))
    downloader.convert_pickle_to_safetensors(port_dir)
    assert os.path.getmtime(os.path.join(port_dir, port_files[0])) == stamp


def test_ensure_local_model_passes_a_local_dir_through(tmp_path, monkeypatch):
    def no_network(*a, **k):
        raise AssertionError("a local directory reached the downloader")
    monkeypatch.setattr(downloader, "download_hf_model", no_network)
    assert downloader.ensure_local_model(str(tmp_path), allow_download=True) == str(tmp_path)
    monkeypatch.chdir(tmp_path)
    os.makedirs("org/name")
    assert downloader.ensure_local_model("org/name", allow_download=True) == "org/name"


def test_factory_keeps_a_clear_error_for_a_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="HYDRAINFER_ALLOW_DOWNLOAD"):
        getModelFactory(ModelFactoryConfig(path="org/not-local"), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        getModelFactory(ModelFactoryConfig(path=str(tmp_path / "missing")), device="cpu")
