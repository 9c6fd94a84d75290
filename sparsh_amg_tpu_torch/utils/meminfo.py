"""Device-memory accounting (the port of ``sparsh_amg_tpu/utils/meminfo.py``).

- `tree_device_bytes(obj)`: bytes of every tensor in a tree of
  dataclasses, tuples, lists and dicts, each storage counted once: the
  persistent footprint of a frozen hierarchy and its fine operators.
- `device_memory_stats(device)`: the CUDA caching allocator's view
  (bytes in use, peak since the last reset); {} off the card.
"""
from __future__ import annotations

import dataclasses

import torch


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def tree_device_bytes(obj) -> int:
    """Total bytes of the distinct tensor storages reachable from obj."""
    seen = {}
    for t in _tensors(obj):
        s = t.untyped_storage()
        seen[(t.device, s.data_ptr())] = s.nbytes()
    return sum(seen.values())


def device_memory_stats(device) -> dict:
    """bytes_in_use and peak_bytes_in_use of the CUDA allocator on
    `device`; {} for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}
