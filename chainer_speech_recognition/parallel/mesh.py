"""DP device mesh + sharding helpers (BASELINE.json:5,11; SURVEY.md §5.8).

The reference had no distributed story (§2.7); here data-parallel training is
first-class: a 1-D mesh over the devices, utterance batches sharded along
the ``data`` axis, gradient all-reduce as ``lax.psum`` inside
``shard_map``. Works identically on 1 GPU, N GPUs, or N fake CPU host
devices (tests, SURVEY.md §4.3).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ParallelConfig


def make_mesh(cfg: ParallelConfig) -> Mesh:
    devices = jax.devices()
    n = cfg.num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if cfg.dcn_slices > 1:
        # several hosts: 2-D (dcn, data) mesh. The data axis is the FAST
        # (minor) axis so jax.make_mesh lays each host's devices
        # contiguously — collectives reduce within a host first, and only
        # host-level partials cross hosts. jax.devices() orders devices by
        # process, which is exactly the row-major (dcn, data)
        # factorization built here.
        if n % cfg.dcn_slices:
            raise ValueError(
                f"{n} devices do not split into {cfg.dcn_slices} dcn slices")
        return jax.make_mesh((cfg.dcn_slices, n // cfg.dcn_slices),
                             (cfg.dcn_axis, cfg.data_axis),
                             devices=devices[:n])
    return jax.make_mesh((n,), (cfg.data_axis,), devices=devices[:n])


def mesh_axes(mesh: Mesh, axis=None):
    """axis=None → shard over ALL mesh axes (1-D ``("data",)`` and 2-D
    multi-slice ``("dcn", "data")`` meshes both fully split the batch).
    THE one place the all-axes default lives — decoders import it too."""
    return tuple(mesh.axis_names) if axis is None else axis


def batch_sharding(mesh: Mesh, axis=None) -> NamedSharding:
    """Leading (utterance) axis sharded over the DP mesh."""
    return NamedSharding(mesh, P(mesh_axes(mesh, axis)))


def dispatch_sharding(mesh: Mesh, ndim: int, axis=None) -> NamedSharding:
    """Slot-id sharding for cached dispatches: [B] shards axis 0, [K, B]
    (multi-step) shards axis 1 — K is replicated time, not data."""
    ax = mesh_axes(mesh, axis)
    return NamedSharding(mesh, P(ax) if ndim == 1 else P(None, ax))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch: dict, axis=None) -> dict:
    """Host→device transfer of a padded bucket, sharded along the batch dim."""
    sh = batch_sharding(mesh, axis)
    return jax.tree.map(lambda x: jax.device_put(x, sh), batch)
