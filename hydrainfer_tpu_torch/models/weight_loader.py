"""Safetensors -> torch tensors (port of hydrainfer_tpu/models/weight_loader.py).

Every *.safetensors shard of a checkpoint directory is opened through the
safetensors numpy framework (imported when a store is made, so the package
imports without it); converters take tensors by name. Linear weights are
stored (in, out) for x @ W. The store records every tensor it hands out, and
`assert_consumed` logs the checkpoint's tensors that no converter read.
"""
import glob
import os
from typing import Dict, List

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logger import getLogger

logger = getLogger(__name__)

_CAST = {None: None, "auto": None, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
         "fp32": torch.float32, "float32": torch.float32, "f32": torch.float32,
         "fp16": torch.float16, "float16": torch.float16}


class WeightStore:
    """Name -> tensor access. Floating tensors are
    cast to `cast_dtype` (a name or a torch dtype) and placed on `device`
    (the card unless "cpu" is asked for)."""

    def __init__(self, path: str, cast_dtype=None, device=None):
        from safetensors import safe_open
        self.path = path
        self.device = resolve_device(device)
        self.cast_dtype = (cast_dtype if isinstance(cast_dtype, torch.dtype)
                           else _CAST[cast_dtype])
        self._handles = {}
        self._key_to_file: Dict[str, str] = {}
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        assert files, f"no *.safetensors under {path}"
        for f in files:
            h = safe_open(f, framework="np")
            self._handles[f] = h
            for k in h.keys():
                self._key_to_file[k] = f
        self._used = set()

    def keys(self) -> List[str]:
        return list(self._key_to_file)

    def has(self, name: str) -> bool:
        return name in self._key_to_file

    def get_np(self, name: str) -> np.ndarray:
        """The stored array; bf16 comes back as its uint16 bit pattern."""
        assert name in self._key_to_file, f"missing tensor {name} in {self.path}"
        self._used.add(name)
        return self._handles[self._key_to_file[name]].get_tensor(name)

    def to_tensor(self, a: np.ndarray) -> torch.Tensor:
        """A numpy array from get_np as a (cast) tensor on the store's device."""
        if a.dtype == np.uint16:  # the numpy framework surfaces bf16 as u16
            t = torch.from_numpy(np.ascontiguousarray(a)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
        if self.cast_dtype is not None and t.is_floating_point():
            t = t.to(self.cast_dtype)
        return t.to(self.device)

    def get(self, name: str, transpose: bool = False) -> torch.Tensor:
        a = self.get_np(name)
        return self.to_tensor(a.T if transpose else a)

    def linear(self, name_prefix: str, bias: bool = False):
        """HF nn.Linear stores (out, in); this returns (in, out)."""
        w = self.get(name_prefix + ".weight", transpose=True)
        if bias:
            b = self.get(name_prefix + ".bias") if self.has(name_prefix + ".bias") else None
            return w, b
        return w

    def fused_linear(self, prefixes: List[str], bias: bool = False):
        """Several HF linears concatenated into one (in, sum_out) matmul."""
        w = torch.cat([self.get(p + ".weight", transpose=True) for p in prefixes], dim=1)
        if not bias:
            return w
        if not self.has(prefixes[0] + ".bias"):
            return w, None
        return w, torch.cat([self.get(p + ".bias") for p in prefixes])

    def assert_consumed(self, ignore_prefixes: tuple = ()) -> None:
        """Log (at warning level, as the JAX store does) the checkpoint's
        tensors that were never read: a misnamed key would else pass
        silently."""
        left = [k for k in self._key_to_file
                if k not in self._used and not k.startswith(ignore_prefixes)]
        if left:
            logger.warning(f"unconsumed checkpoint tensors: {left[:20]}"
                           + ("..." if len(left) > 20 else ""))
