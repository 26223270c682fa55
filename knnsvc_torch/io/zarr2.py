"""zarr v2 arrays in a key-value store, as orbax keeps each leaf of a
checkpoint: `<name>/.zarray` (JSON metadata) and one value per chunk,
`<name>/i.j.k` (`<name>/0` for a scalar), each one zstd frame.

Read: the dtypes numpy knows ("<f4", "<i4", "<i8", ...) and "bfloat16",
which comes back as a torch.bfloat16 tensor (its bits through an int16 view);
C order; no filters; the zstd compressor; fill_value null (every chunk
present, as orbax writes them); several chunks, assembled in place. Anything
else raises NotImplementedError naming it (zarr v3 and its sharding codec,
another compressor or none, Fortran order, a fill value).
Written: one chunk holding the whole array, as orbax writes it, compressed
as one zstd frame of raw blocks.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Callable

import numpy as np
import torch

from knnsvc_torch.io.ocdbt import zstd_decode_into, zstd_frame

BFLOAT16 = "bfloat16"


def _dtype(name: str) -> np.dtype:
    if name == BFLOAT16:
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise NotImplementedError(f"zarr dtype {name!r}") from e
    if dt.fields is not None or dt.subdtype is not None or dt.kind not in "biuf":
        raise NotImplementedError(f"zarr dtype {name!r}")
    return dt


def parse_zarray(raw: bytes) -> dict:
    """A .zarray document, checked against what this reader handles."""
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"zarr format {meta.get('zarr_format')!r} (only v2 is read)")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"zarr order {meta['order']!r} (only C order is read)")
    if meta.get("filters"):
        raise NotImplementedError(f"zarr filters {meta['filters']!r}")
    comp = meta.get("compressor")
    if not comp or comp.get("id") != "zstd":
        raise NotImplementedError(f"zarr compressor {comp!r} (only zstd is read)")
    if meta.get("dimension_separator", ".") != ".":
        raise NotImplementedError(f"zarr dimension separator {meta['dimension_separator']!r}")
    if meta.get("fill_value") is not None:
        raise NotImplementedError(f"zarr fill value {meta['fill_value']!r}")
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks) or any(s < 0 for s in shape):
        raise ValueError(f"zarr shape {shape} and chunks {chunks} disagree")
    _dtype(meta["dtype"])
    return meta


def read_array(get: Callable[[str], bytes | None], name: str, meta: dict):
    """The array `name` of a store, from its parsed .zarray: a numpy array,
    or a torch.bfloat16 tensor. get(key) -> the value's bytes, or None when
    the store holds no such key."""
    dt = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    out = np.empty(shape, dt)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    whole = list(grid) == [1] * len(shape) and chunks == shape
    for index in itertools.product(*[range(g) for g in grid]):
        key = f"{name}/{'.'.join(str(i) for i in index) if index else '0'}"
        data = get(key)
        if data is None:
            raise ValueError(f"zarr chunk {key} is missing and the array has no fill value")
        target = out if whole else np.empty(chunks, dt)
        try:
            zstd_decode_into(data, target.reshape(-1).view(np.uint8))
        except ValueError as e:
            raise ValueError(f"zarr chunk {key}: {e}") from None
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        if not whole:
            out[region] = target[tuple(slice(0, r.stop - r.start) for r in region)]
    out = out.astype(dt.newbyteorder("="), copy=False)
    if meta["dtype"] == BFLOAT16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def array_values(name: str, value) -> dict[str, object]:
    """{key: value} of one array (a numpy array or scalar, or a torch
    tensor): its .zarray and its one chunk, a callable that makes the zstd
    frame when the store writes it."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, dtype = t.view(torch.int16).numpy().view(np.uint16), BFLOAT16
        else:
            arr = t.numpy()
            dtype = None
    else:
        arr, dtype = np.asarray(value), None
    arr = np.array(arr, order="C", copy=not arr.flags.c_contiguous)   # keeps 0-d arrays 0-d
    if dtype is None:
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        arr = arr.astype(dt, copy=False)
        dtype = dt.str
        _dtype(dtype)
    meta = {"chunks": [max(1, n) for n in arr.shape], "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None,
            "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    values: dict[str, object] = {
        f"{name}/.zarray": json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()}
    if arr.size:
        chunk = ".".join("0" for _ in arr.shape) if arr.shape else "0"
        values[f"{name}/{chunk}"] = lambda: zstd_frame(arr)
    return values
