"""Device-memory accounting (the port of ``sparsh_amg_tpu/utils/meminfo.py``).

- `tree_device_bytes(obj)`: bytes of every tensor in a tree of
  dataclasses, tuples, lists and dicts, each storage counted once: the
  persistent footprint of a frozen hierarchy and its fine operators.
- `device_memory_stats(device)`: the CUDA caching allocator's view
  (bytes in use, peak since the last reset) and the card's memory; {}
  off the card;
- `hbm_spec_bw(device)`: the card's data-sheet memory rate, and
  `card_name_and_power_limit()`: what nvidia-smi reports of the card.
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


def tree_device_bytes(obj, seen: set | None = None) -> int:
    """Total bytes of the distinct tensor storages reachable from obj.
    With `seen`, storages already in it are skipped and the new ones
    added, so several calls count each storage once between them."""
    seen = set() if seen is None else seen
    total = 0
    for t in _tensors(obj):
        s = t.untyped_storage()
        key = (t.device, s.data_ptr())
        if key not in seen:
            seen.add(key)
            total += s.nbytes()
    return total


# Data-sheet device-memory rates (bytes/s) by CUDA device name: the fixed
# denominator of every bound and memory-rate fraction, beside the copy
# rate measured in the same run (NVIDIA's data sheets, SXM parts).
_HBM_SPEC_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12, "H200": 4.8e12}


def spec_bw_of(name: str) -> float:
    """The data-sheet memory rate of the card named `name`
    (``torch.cuda.get_device_name``); ValueError for a card not in the
    table, so no other card's rate is ever printed as this one's."""
    for key, rate in _HBM_SPEC_BYTES_PER_S.items():
        if key in name:
            return rate
    raise ValueError(f"no data-sheet memory rate for {name!r} (known: "
                     f"{sorted(_HBM_SPEC_BYTES_PER_S)})")


def hbm_spec_bw(device) -> float:
    """Data-sheet device-memory rate (bytes/s) of the CUDA `device`."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no device-memory rate for a {device.type} device")
    return spec_bw_of(torch.cuda.get_device_name(device))


def device_memory_stats(device) -> dict:
    """bytes_in_use and peak_bytes_in_use of the CUDA allocator on
    `device`, peak_bytes_reserved (the allocator's pools, CUDA graph
    pools included: a graph's work tensors stay reserved for its replays
    but count as in use only while it is captured) and the card's memory
    (bytes_limit); {} for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "peak_bytes_reserved": torch.cuda.max_memory_reserved(device),
            "bytes_limit": torch.cuda.mem_get_info(device)[1]}


def card_name_and_power_limit() -> tuple:
    """(name, power limit in W) of the first card as nvidia-smi reports
    them (``--query-gpu=name,power.limit``), and the raw line."""
    import subprocess
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, limit = (f.strip() for f in line.rsplit(",", 1))
    try:
        watts = float(limit.split()[0])
    except (ValueError, IndexError):       # "[N/A]" on some cards
        watts = None
    return name, watts, line
