"""One-dispatch setup fusion.

Every distinct jitted graph pays a per-process first-call cost (trace +
lower + compile-cache load) and every separate ``jnp.asarray`` upload
pays its own transfer.  This module collapses an arbitrary set of setup builds into

* ONE int32 blob upload  (all input arrays bit-packed host-side), and
* ONE jitted dispatch    (each build's device-side constructor runs on
  slices of the blob inside the same graph),

keyed on the builds' static signature so repeated setups of same-shaped
problems reuse the compiled graph.

The reference has no analog (scipy/SuperLU run in-process,
``ILUTPreconditioner.py:51-53``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class SetupItem(NamedTuple):
    """One deferred device build: ``build(arrays, statics) -> pytree``.

    ``build`` must be a module-level (stable-identity) traceable function;
    the fused jit is cached on ``(build, statics, array specs)``.

    Wrap an array in ``DeviceCached`` when it is STRUCTURE (index/plan
    data fixed across re-setups): it uploads once per process and stays
    device-resident, so warm re-setups ship only the value arrays.
    """

    arrays: tuple
    build: Callable
    statics: tuple


class DeviceCached:
    """Marker for a structure array in SetupItem.arrays (see SetupItem).

    Index dtypes are normalized the way the blob packer does (uint8 and
    in-range int64 widen/narrow to int32), so a build function sees the
    same dtypes whether its array arrived via the blob or the cache."""

    __slots__ = ("array", "key")

    def __init__(self, array: np.ndarray):
        a = np.ascontiguousarray(array)
        if a.dtype == np.uint8:
            a = a.astype(np.int32)
        elif a.dtype == np.int64:
            if a.size and (np.abs(a) > 2 ** 31 - 1).any():
                raise ValueError("int64 array exceeds int32 range")
            a = a.astype(np.int32)
        self.array = a
        self.key = (hash(a.tobytes()), a.dtype.str, a.shape)


# device-resident structure arrays, keyed on content (bounded)
_DEV_STRUCT_CACHE: dict = {}


def _dev_cached(dc: DeviceCached) -> jax.Array:
    ent = _DEV_STRUCT_CACHE.get(dc.key)
    if ent is None:
        ent = jnp.asarray(dc.array)
        if len(_DEV_STRUCT_CACHE) > 32:
            _DEV_STRUCT_CACHE.pop(next(iter(_DEV_STRUCT_CACHE)))
        _DEV_STRUCT_CACHE[dc.key] = ent
    return ent


def _to_words(a: np.ndarray):
    """Host array -> (int32 word view, kind, logical shape)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32).ravel(), "f32", a.shape
    if a.dtype == np.int32:
        return a.ravel(), "i32", a.shape
    if a.dtype == np.float64:
        if not jax.config.jax_enable_x64:
            # bitcast_convert_type silently truncates to f32 with x64
            # off, producing a cryptic shape error far from the cause
            raise ValueError(
                "fused_build received a float64 array but jax_enable_x64 "
                "is off — enable x64 or cast the array to float32")
        return a.view(np.int32).ravel(), "f64", a.shape
    if a.dtype == np.uint8:
        # widen host-side: lane-index streams are small and int32 keeps
        # the blob layout trivial
        return a.astype(np.int32).ravel(), "i32", a.shape
    if a.dtype == np.int64:
        if a.size and (np.abs(a) > 2 ** 31 - 1).any():
            raise ValueError("int64 array exceeds int32 range; blob "
                             "packing stores indices as int32")
        return a.astype(np.int32).ravel(), "i32", a.shape
    raise TypeError(f"unsupported blob dtype {a.dtype}")


def blob_pack(arrays: Sequence[np.ndarray]):
    """Pack host arrays into one int32 blob + static layout spec."""
    parts, specs, off = [], [], 0
    for a in arrays:
        w, kind, shape = _to_words(np.asarray(a))
        parts.append(w)
        specs.append((kind, tuple(int(s) for s in shape), off))
        off += len(w)
    blob = (np.concatenate(parts) if parts
            else np.zeros(0, dtype=np.int32))
    return blob, tuple(specs)


def blob_split(blob: jax.Array, specs):
    """Recover the original arrays from the blob (jit-traceable; static
    slicing only)."""
    out = []
    for kind, shape, off in specs:
        n = int(np.prod(shape)) if shape else 1
        if kind == "i32":
            x = blob[off:off + n]
        elif kind == "f32":
            x = jax.lax.bitcast_convert_type(blob[off:off + n],
                                             jnp.float32)
        elif kind == "f64":
            words = blob[off:off + 2 * n].reshape(n, 2)
            x = jax.lax.bitcast_convert_type(_f64_order(words),
                                             jnp.float64)
        else:  # pragma: no cover
            raise ValueError(kind)
        out.append(x.reshape(shape))
    return out


_F64_SWAP = None


def _f64_order(words):
    """Word order for the 2×int32 → f64 bitcast.

    numpy on a little-endian host stores the low word first; XLA's
    BitcastConvert composes the wide value with index 0 least-significant
    on LE backends.  Probed once (host-side, no device dispatch) and
    cached; swaps the pair if the convention ever differs.
    """
    global _F64_SWAP
    if _F64_SWAP is None:
        probe = np.array([1.5], dtype=np.float64).view(np.int32)
        with jax.ensure_compile_time_eval():
            val = np.asarray(jax.lax.bitcast_convert_type(
                jnp.asarray(probe.reshape(1, 2)), jnp.float64))
        _F64_SWAP = not bool(val[0] == 1.5)
    return words[:, ::-1] if _F64_SWAP else words


def passthrough_build(arrs, st):
    """Builder that just lands the arrays on device (upload-only items,
    e.g. smoother diagonals riding along a fused hierarchy build)."""
    return arrs[0] if len(arrs) == 1 else tuple(arrs)


_FUSE_CACHE: dict = {}


def _pack_items(items: Sequence[SetupItem]):
    """Split each item's arrays into blob-bound values and DeviceCached
    structure.  Returns (blob, layouts, cached_arrays) where each layout
    entry is either ("blob", kind, shape, off) or ("cached", j) with j
    indexing into the flat cached-array list."""
    blobs, layouts, cached = [], [], []
    off = 0
    for it in items:
        lay = []
        for a in it.arrays:
            if isinstance(a, DeviceCached):
                lay.append(("cached", len(cached)))
                cached.append(a)
                continue
            w, kind, shape = _to_words(np.asarray(a))
            blobs.append(w)
            lay.append(("blob", kind, shape, off))
            off += len(w)
        layouts.append(tuple(lay))
    blob = (np.concatenate(blobs) if blobs
            else np.zeros(0, dtype=np.int32))
    return blob, tuple(layouts), cached


def _split_items(blob, lay, cached_args):
    """Reconstitute one item's array list (jit-traceable)."""
    out = []
    for ent in lay:
        if ent[0] == "cached":
            out.append(cached_args[ent[1]])
            continue
        _, kind, shape, off = ent
        n = int(np.prod(shape)) if shape else 1
        if kind == "i32":
            x = blob[off:off + n]
        elif kind == "f32":
            x = jax.lax.bitcast_convert_type(blob[off:off + n],
                                             jnp.float32)
        elif kind == "f64":
            words = blob[off:off + 2 * n].reshape(n, 2)
            x = jax.lax.bitcast_convert_type(_f64_order(words),
                                             jnp.float64)
        else:  # pragma: no cover
            raise ValueError(kind)
        out.append(x.reshape(shape))
    return out


def fused_build(items: Sequence[SetupItem]):
    """Run every item's device build in ONE dispatch.

    Returns the list of build outputs (device pytrees), in order.
    DeviceCached arrays ride as separate device-resident jit arguments,
    uploaded once per process.
    """
    blob, layouts, cached = _pack_items(items)
    # cached arrays key on (dtype, shape) only — their VALUES are traced
    # jit arguments, so same-layout structure swaps reuse the compilation
    key = (tuple((it.build, lay, it.statics)
                 for it, lay in zip(items, layouts)),
           tuple(dc.key[1:] for dc in cached))
    fn = _FUSE_CACHE.get(key)
    if fn is None:
        builds = [it.build for it in items]
        statics = [it.statics for it in items]
        lays = list(layouts)

        @jax.jit
        def fn(blob, *cached_args):
            return tuple(bld(_split_items(blob, lay, cached_args), st)
                         for bld, lay, st in zip(builds, lays, statics))

        if len(_FUSE_CACHE) > 64:
            _FUSE_CACHE.pop(next(iter(_FUSE_CACHE)))
        _FUSE_CACHE[key] = fn
    cached_dev = [_dev_cached(dc) for dc in cached]
    return list(fn(jnp.asarray(blob), *cached_dev))
