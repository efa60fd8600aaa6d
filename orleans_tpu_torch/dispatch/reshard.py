"""Elastic resharding of a dense actor table: re-range its keyspace onto a
mesh with a different shard count, in either direction.

The port of ``orleans_tpu.dispatch.reshard``. The dense regime's block
mapping key → (key // per_shard, key % per_shard) is the directory, so a
re-range is snapshot → key-major flatten → block re-partition → restore,
in numpy over the tables' ``snapshot``/``restore``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["reshard_dense"]


def reshard_dense(old_table, new_rt):
    """Re-range ``old_table``'s dense keyspace onto ``new_rt``'s mesh (any
    shard counts) and return the new table. State rows carry over exactly,
    and so does the activation bitmap, so rehydrated rows are not
    re-initialized on their next touch. The old table is left as it was."""
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
    snap = old_table.snapshot()
    per_old = old_table.dense_per_shard
    n_old = old_table.n_shards

    tbl2 = new_rt.table(cls)
    tbl2.ensure_dense(n_keys)
    per_new = tbl2.dense_per_shard
    m = tbl2.n_shards
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
        restored[name] = full
    tbl2.restore(restored)
    tbl2.dense_active[:] = old_table.dense_active[:n_keys]
    return tbl2
