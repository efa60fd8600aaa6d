"""Elastic resharding of a dense actor table: re-range its keyspace onto a
mesh with a different shard count, in either direction.

The port of ``orleans_tpu.dispatch.reshard``. The dense regime's block
mapping key → (key // per_shard, key % per_shard) is the directory, so a
re-range is snapshot → key-major flatten → block re-partition → restore,
in numpy over the tables' ``snapshot``/``restore``.

Across the ranks of a process group both meshes span the same group:
each rank gathers every rank's rows (``parallel.gather``), re-ranges the
whole keyspace as above and keeps its own rows of the new mesh; the
activation bitmap is replicated already.
"""

from __future__ import annotations

import numpy as np

from ..parallel.mesh import gather

__all__ = ["reshard_dense"]


def reshard_dense(old_table, new_rt):
    """Re-range ``old_table``'s dense keyspace onto ``new_rt``'s mesh (any
    shard counts) and return the new table. State rows carry over exactly,
    and so does the activation bitmap, so rehydrated rows are not
    re-initialized on their next touch. The old table is left as it was.

    Across ranks both meshes must span the same process group (so both
    shard counts divide by its world); else ``ValueError``."""
    old_mesh, new_mesh = old_table.mesh, new_rt.mesh
    if old_mesh.group is not new_mesh.group:
        raise ValueError(
            f"reshard_dense runs between two meshes over the same process "
            f"group: a {old_mesh.n_shards}-shard mesh over "
            f"{old_mesh.world} rank(s) and a {new_mesh.n_shards}-shard "
            f"mesh over {new_mesh.world} rank(s) are not")
    cls = old_table.grain_class
    n_keys = old_table.dense_n
    if n_keys == 0 or old_table.dense_per_shard == 0:
        raise ValueError(
            "reshard_dense re-ranges the dense regime; hashed-key tables "
            "migrate per key through checkpoint restore")
    if old_table.key_to_slot:
        raise ValueError(
            "table mixes hashed keys with the dense range; release the "
            "hashed activations before a dense re-range")
    # every rank's rows on the host, [n_global, C+1, ...]; nothing below
    # writes into them
    with old_table.fence:
        snap = {k: gather(old_mesh, v).cpu().numpy()
                for k, v in old_table.state.items()}
    per_old = old_table.dense_per_shard
    n_old = old_table.n_global

    tbl2 = new_rt.table(cls)
    tbl2.ensure_dense(n_keys)
    per_new = tbl2.dense_per_shard
    m = tbl2.n_global
    mine = slice(tbl2.shard0, tbl2.shard0 + tbl2.n_shards)
    restored = {}
    for name, arr in snap.items():
        # key-major flatten of the old block mapping, cut to the real
        # keyspace (the old last shard's tail rows are padding)
        km = arr[:, :per_old].reshape(n_old * per_old,
                                      *arr.shape[2:])[:n_keys]
        pad = m * per_new - n_keys
        if pad:
            km = np.concatenate(
                [km, np.zeros((pad, *km.shape[1:]), km.dtype)])
        full = np.zeros((m, tbl2.capacity + 1, *km.shape[1:]), km.dtype)
        full[:, :per_new] = km.reshape(m, per_new, *km.shape[1:])
        restored[name] = full[mine]
    tbl2.restore(restored)
    tbl2.dense_active[:] = old_table.dense_active[:n_keys]
    return tbl2
