"""Hugging Face checkpoint downloader (port of
hydrainfer_tpu/models/downloader.py).

It snapshot-downloads a repository's configs, tokenizer files and weights,
preferring safetensors; a repository with only pickles (.bin / .pth) is
converted on disk to safetensors, the one format models/weight_loader.py
reads. Nothing is fetched unless HYDRAINFER_ALLOW_DOWNLOAD=1 is set or
`allow_download=True` is passed. `getModelFactory` calls
`ensure_local_model` on a model path that is not a directory, so
`model.path=org/name` downloads where that is allowed.
"""
import os
from typing import Optional

from ..utils.logger import getLogger

logger = getLogger(__name__)


def downloads_enabled(allow_download: Optional[bool] = None) -> bool:
    if allow_download is not None:
        return allow_download
    return os.environ.get("HYDRAINFER_ALLOW_DOWNLOAD", "0") == "1"


def convert_pickle_to_safetensors(path: str) -> None:
    """Write a sibling .safetensors file for every .bin / .pth pickle of
    tensors under `path`. Already converted files, pickles that are not
    weights-only and pickles that hold anything but tensors are skipped."""
    import torch
    from safetensors.torch import save_file

    for filename in os.listdir(path):
        if not filename.endswith((".bin", ".pth")):
            continue
        st_path = os.path.join(path, os.path.splitext(filename)[0] + ".safetensors")
        if os.path.exists(st_path):
            continue
        # weights_only: a downloaded repository's pickle runs no code
        try:
            obj = torch.load(os.path.join(path, filename), map_location="cpu",
                             weights_only=True)
        except Exception:
            logger.warning(f"{filename} is not a weights-only pickle; "
                           "skipping (convert it manually if trusted)")
            continue
        state_dict = obj.state_dict() if hasattr(obj, "state_dict") else obj
        if not isinstance(state_dict, dict) or not all(
                isinstance(v, torch.Tensor) for v in state_dict.values()):
            logger.info(f"ignoring non-tensor pickle file: {filename}")
            continue
        # clones: safetensors refuses tensors that share storage
        save_file({k: v.clone() for k, v in state_dict.items()}, st_path)
        logger.info(f"converted {filename} -> {os.path.basename(st_path)}")


def download_hf_model(repo_id: str, revision: Optional[str] = None,
                      allow_patterns: Optional[str] = None,
                      cache_dir: Optional[str] = None,
                      convert_to_safetensors: bool = True,
                      allow_download: Optional[bool] = None) -> str:
    """Snapshot-download `repo_id` and return its local path.

    allow_patterns: comma-separated filename globs; by default the configs,
    the tokenizer files and the safetensors (or, in a repository without
    safetensors, the pickles, converted here)."""
    assert repo_id, "provide a repo_id"
    if not downloads_enabled(allow_download):
        raise RuntimeError(
            f"model download of {repo_id!r} requested but downloads are "
            "disabled in this environment; set HYDRAINFER_ALLOW_DOWNLOAD=1 "
            "or pre-stage the checkpoint and pass its local path")

    from huggingface_hub import HfApi, snapshot_download

    revision = revision or "main"
    files = HfApi().list_repo_files(repo_id=repo_id, revision=revision)
    has_safetensors = any(f.endswith(".safetensors") for f in files)
    if not allow_patterns:
        allow_patterns = "*.json,*.tiktoken,*.model,*.txt"
        allow_patterns += ",*.safetensors" if has_safetensors else ",*.bin,*.pth"
    path = snapshot_download(repo_id, revision=revision, cache_dir=cache_dir,
                             allow_patterns=allow_patterns.split(","))
    if convert_to_safetensors and not has_safetensors:
        convert_pickle_to_safetensors(path)
    logger.info(f"downloaded {repo_id}@{revision} -> {path}")
    return path


def ensure_local_model(path: str, allow_download: Optional[bool] = None) -> str:
    """A local directory passes through; a relative "org/name" is downloaded
    when downloads are enabled; anything else comes back unchanged."""
    if os.path.isdir(path):
        return path
    looks_like_repo = ("/" in path and not os.path.isabs(path)
                       and path.count("/") == 1)
    if looks_like_repo and downloads_enabled(allow_download):
        return download_hf_model(path, allow_download=allow_download)
    return path
