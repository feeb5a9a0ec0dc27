"""Carry a gdpt_tpu scene across to this package.

The JAX package hands over its DeviceScene as the flat list of its leaves
(numpy arrays, in jax.tree_util order: NamedTuple fields in order,
depth first) and its SceneStatic as plain field values. This module
rebuilds the port's Scene from them, so that both packages can render
the very same scene tables. It is the port's counterpart of carrying
model weights across; nothing here imports jax.
"""

import typing

import numpy as np
import torch

from gdpt_tpu_torch.accel.packet_trace import PacketTable
from gdpt_tpu_torch.core.dtypes import resolve_device
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.scene.build import DeviceScene, Scene, SceneStatic


def tree_leaves(tree):
    """Leaves of a NamedTuple/tuple tree in jax.tree_util order (tensors
    and Python scalars; None has no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


def _is_namedtuple(ann):
    return isinstance(ann, type) and issubclass(ann, tuple) and hasattr(ann, "_fields")


def _unflatten(ann, leaves, n_media, device):
    if _is_namedtuple(ann):
        hints = typing.get_type_hints(ann)
        return ann(*(_unflatten(hints[f], leaves, n_media, device)
                     for f in ann._fields))
    if typing.get_origin(ann) is tuple:  # Tuple[MediumArrays, ...]
        inner = typing.get_args(ann)[0]
        return tuple(_unflatten(inner, leaves, n_media, device)
                     for _ in range(n_media))
    leaf = next(leaves)
    if ann in (int, float):
        return ann(np.asarray(leaf))
    return torch.from_numpy(np.array(leaf, copy=True)).to(device)


def scene_from_numpy(leaves, static_fields, device=None) -> Scene:
    """leaves: the reference DeviceScene's leaves as numpy arrays;
    static_fields: its SceneStatic fields as a dict of plain values (the
    render options as a dict or an object with the same attributes)."""
    device = resolve_device(device)
    fields = dict(static_fields)
    opts = fields["options"]
    if not isinstance(opts, M.RenderOptions):
        get = opts.get if isinstance(opts, dict) else lambda k: getattr(opts, k)
        fields["options"] = M.RenderOptions(
            **{k: get(k) for k in M.RenderOptions.__dataclass_fields__})
    static = SceneStatic(**fields)
    it = iter(leaves)
    dev = _unflatten(DeviceScene, it, len(static.media_phase_kinds), device)
    if next(it, None) is not None:
        raise ValueError("more leaves than the port's DeviceScene holds")
    return Scene(dev, static)


def packet_table_from_numpy(table, bbox, geo9, entry_ref, entry_bbox, stack_n,
                            width, device=None) -> PacketTable:
    """The reference's PacketTable as the port's: its array leaves as
    numpy arrays, its stack size (the length of its stack_dummy) and its
    width (32 where it carries a wide marker, else 16)."""
    device = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)

    return PacketTable(put(table, np.int32), put(bbox, np.float32), put(geo9, np.float32),
                       put(entry_ref, np.int32), put(entry_bbox, np.float32),
                       int(stack_n), int(width))
