"""The port's device-tier checkpoint/resume (orleans_tpu_torch.storage
.checkpoint: ``torch.save`` table snapshots and write-behind per-actor
persistence), held against tests/test_checkpoint.py's cases and against
the JAX package on the same calls, on the CPU.

Each case of ``TestVectorCheckpointer``/``TestVectorStorageBridge`` runs
on the port; where the JAX package runs the same case, the results and
the tables it leaves (the sink row left out) must be equal. Records that
the JAX package's bridge stored load in the port's bridge: they cross as
values (decoded by the JAX package, re-encoded by the port's pickle-only
serializer). Tolerance: exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orleans_tpu.core.serialization as jser
import orleans_tpu.dispatch as jd
import orleans_tpu.storage as js
from orleans_tpu.parallel import make_mesh as j_mesh
import orleans_tpu_torch.core.serialization as tser
import orleans_tpu_torch.dispatch as td
import orleans_tpu_torch.storage as ts
from orleans_tpu_torch.ops import split64
from orleans_tpu_torch.parallel import make_mesh as t_mesh


class JCounterGrain(jd.VectorGrain):
    STATE = {"count": (jnp.int32, ()), "last": (jnp.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": jnp.int32(0), "last": jnp.float32(0)}

    @jd.actor_method(args={"x": (jnp.float32, ())})
    def bump(state, args):
        return {"count": state["count"] + 1, "last": args["x"]}, \
            state["count"] + 1


class TCounterGrain(td.VectorGrain):
    STATE = {"count": (torch.int32, ()), "last": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": torch.zeros_like(key_hash),
                "last": key_hash.new_zeros((), dtype=torch.float32)}

    @td.actor_method(args={"x": (torch.float32, ())})
    def bump(state, args):
        return {"count": state["count"] + 1, "last": args["x"]}, \
            state["count"] + 1


for _cls in (JCounterGrain, TCounterGrain):
    _cls.__name__ = _cls.__qualname__ = "CounterGrain"


def _runtime(n_players=64, capacity=32) -> td.VectorRuntime:
    rt = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                          capacity_per_shard=capacity)
    rt.table(TCounterGrain).ensure_dense(n_players)
    return rt


def _j_runtime(n_players=64, capacity=32) -> jd.VectorRuntime:
    rt = jd.VectorRuntime(mesh=j_mesh(8), capacity_per_shard=capacity)
    rt.table(JCounterGrain).ensure_dense(n_players)
    return rt


def _bump_all(rt, n, x, cls=TCounterGrain):
    return rt.call_batch(cls, "bump", np.arange(n),
                         {"x": np.full(n, x, np.float32)})


def _rows(tbl) -> dict:
    return {k: v[:, :-1] for k, v in tbl.snapshot().items()}


def _assert_same_rows(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


class TestVectorCheckpointer:
    def test_save_restore_roundtrip(self, tmp_path):
        rt = _runtime()
        _bump_all(rt, 64, 1.5)
        _bump_all(rt, 64, 2.5)
        ckpt = ts.VectorCheckpointer(rt, str(tmp_path), max_to_keep=2)
        ckpt.save(step=2)
        ckpt.wait()
        rt2 = _runtime()
        assert ts.VectorCheckpointer(rt2, str(tmp_path)).restore() == 2
        # the whole pool, sink row included, comes back bit for bit
        before, after = rt.table(TCounterGrain), rt2.table(TCounterGrain)
        for f in before.state:
            assert torch.equal(before.state[f], after.state[f]), f
        row = after.read_row(17)
        assert int(row["count"]) == 2 and float(row["last"]) == 2.5
        out = _bump_all(rt2, 64, 9.0)
        assert (np.asarray(out) == 3).all()
        # the JAX package resumes the same calls to the same table
        jrt = _j_runtime()
        _bump_all(jrt, 64, 1.5, JCounterGrain)
        _bump_all(jrt, 64, 2.5, JCounterGrain)
        jck = js.VectorCheckpointer(jrt, str(tmp_path / "jax"))
        jck.save(2)
        jck.wait()
        jrt2 = _j_runtime()
        js.VectorCheckpointer(jrt2, str(tmp_path / "jax")).restore()
        jout = _bump_all(jrt2, 64, 9.0, JCounterGrain)
        assert np.array_equal(np.asarray(jout), out)
        _assert_same_rows(_rows(jrt2.table(JCounterGrain)),
                          _rows(rt2.table(TCounterGrain)))
        jck.close()

    def test_retention_and_latest(self, tmp_path):
        rt = _runtime(8)
        ckpt = ts.VectorCheckpointer(rt, str(tmp_path), max_to_keep=2)
        for s in (1, 2, 3):
            _bump_all(rt, 8, float(s))
            ckpt.save(s)
        ckpt.wait()
        assert ckpt.latest_step() == 3
        assert ckpt.all_steps() == [2, 3]
        assert sorted(os.listdir(tmp_path)) == ["2", "3"]
        # a write that never finished leaves a temporary directory, which
        # is not a step
        (tmp_path / ".tmp-4-dead").mkdir()
        assert ts.VectorCheckpointer(rt, str(tmp_path)).latest_step() == 3

    def test_restore_requires_registration(self, tmp_path):
        rt = _runtime(8)
        _bump_all(rt, 8, 1.0)
        ckpt = ts.VectorCheckpointer(rt, str(tmp_path))
        ckpt.save(1)
        empty = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                                 capacity_per_shard=32)
        with pytest.raises(KeyError, match="not registered"):
            ts.VectorCheckpointer(empty, str(tmp_path)).restore()
        with pytest.raises(FileNotFoundError):
            ts.VectorCheckpointer(rt, str(tmp_path / "none")).restore()

    def test_restore_refuses_another_schema(self, tmp_path):
        rt = _runtime(8)
        ts.VectorCheckpointer(rt, str(tmp_path)).save(1)

        class Wider(td.VectorGrain):
            STATE = {"count": (torch.int64, ()), "last": (torch.float32, ())}

            @staticmethod
            def initial_state(key_hash):
                return {"count": key_hash.long() * 0,
                        "last": key_hash.new_zeros((), dtype=torch.float32)}

        Wider.__name__ = "CounterGrain"
        other = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                                 capacity_per_shard=32)
        other.register(Wider)
        with pytest.raises(ValueError, match="schema wants"):
            ts.VectorCheckpointer(other, str(tmp_path)).restore()

    def test_restore_into_different_capacity_runtime(self, tmp_path):
        rt = _runtime()
        _bump_all(rt, 64, 7.0)
        ckpt = ts.VectorCheckpointer(rt, str(tmp_path))
        ckpt.save(1)
        rt2 = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                               capacity_per_shard=128)
        rt2.table(TCounterGrain).ensure_dense(64)
        ts.VectorCheckpointer(rt2, str(tmp_path)).restore()
        tbl = rt2.table(TCounterGrain)
        assert tbl.capacity == 32  # the checkpoint's capacity wins
        assert int(tbl.read_row(63)["count"]) == 1

    def test_hashed_keys_roundtrip(self, tmp_path):
        rt = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                              capacity_per_shard=16)
        rt.register(TCounterGrain)
        tbl = rt.table(TCounterGrain)
        big = 10**9 + 7  # hashed regime (beyond any dense range)
        shard, slot, fresh = tbl.lookup_or_allocate(big)
        assert fresh
        ts.VectorCheckpointer(rt, str(tmp_path)).save(1)
        rt2 = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                               capacity_per_shard=16)
        rt2.register(TCounterGrain)
        ts.VectorCheckpointer(rt2, str(tmp_path)).restore()
        tbl2 = rt2.table(TCounterGrain)
        assert tbl2.lookup(big) == (shard, slot)
        # the on-device directory follows the restored key map
        lo, hi = split64(np.array([big, big + 1]))
        loc, found = tbl2.device_dir.lookup_batch(lo, hi)
        assert found.tolist() == [True, False]
        assert int(loc[0]) == tbl2._encode_loc(shard, slot)


class TestVectorStorageBridge:
    async def test_flush_then_load_after_restart(self):
        storage = ts.MemoryStorage()
        rt = _runtime(16)
        _bump_all(rt, 16, 4.25)
        bridge = ts.VectorStorageBridge(rt, TCounterGrain, storage)
        assert await bridge.flush(range(16)) == 16
        rt2 = _runtime(16)
        bridge2 = ts.VectorStorageBridge(rt2, TCounterGrain, storage)
        loaded = await bridge2.load(range(16))
        assert loaded == list(range(16))
        row = rt2.table(TCounterGrain).read_row(5)
        assert int(row["count"]) == 1 and float(row["last"]) == 4.25
        out = _bump_all(rt2, 16, 0.0)
        assert (np.asarray(out) == 2).all()

    async def test_flush_after_checkpoint_restore_adopts_etags(self, tmp_path):
        storage = ts.MemoryStorage()
        rt = _runtime(8)
        _bump_all(rt, 8, 1.0)
        await ts.VectorStorageBridge(rt, TCounterGrain, storage).flush(
            range(8))
        ts.VectorCheckpointer(rt, str(tmp_path)).save(1)
        rt2 = _runtime(8)
        ts.VectorCheckpointer(rt2, str(tmp_path)).restore()
        _bump_all(rt2, 8, 2.0)  # newer device state than storage
        bridge2 = ts.VectorStorageBridge(rt2, TCounterGrain, storage)
        assert await bridge2.flush(range(8)) == 8  # no InconsistentState
        state, _ = await storage.read("CounterGrain", bridge2._grain_id(3))
        assert int(state["count"]) == 2 and float(state["last"]) == 2.0

    async def test_load_missing_keys_stay_fresh(self):
        rt = _runtime(8)
        bridge = ts.VectorStorageBridge(rt, TCounterGrain, ts.MemoryStorage())
        assert await bridge.load([3, 4]) == []

    async def test_flush_unknown_key_dropped(self):
        rt = _runtime(8)
        bridge = ts.VectorStorageBridge(rt, TCounterGrain, ts.MemoryStorage())
        assert await bridge.flush([999]) == 0

    async def test_flush_isolates_per_key_storage_failures(self):
        rt = _runtime(8)
        rt.enable_dirty_tracking()
        storage = ts.MemoryStorage()
        bridge = ts.VectorStorageBridge(rt, TCounterGrain, storage)
        tbl = rt.table(TCounterGrain)
        for k in (1, 2, 3):
            tbl.lookup_or_allocate(k)
        real_write = storage.write

        async def flaky_write(grain_type, grain_id, state, etag):
            if grain_id.key == 2:
                raise RuntimeError("injected storage fault")
            return await real_write(grain_type, grain_id, state, etag)

        storage.write = flaky_write
        rt.drain_dirty(TCounterGrain)
        assert await bridge.flush([1, 2, 3]) == 2
        assert sorted(int(k) for k in rt.drain_dirty(TCounterGrain)) == [2]
        s1, _ = await storage.read("CounterGrain", bridge._grain_id(1))
        s2, _ = await storage.read("CounterGrain", bridge._grain_id(2))
        assert s1 is not None and s2 is None
        # a strict flush surfaces the failure after re-marking
        with pytest.raises(RuntimeError, match="injected"):
            await bridge.flush([2], strict=True)

    async def test_hashed_key_flush_and_load(self):
        storage = ts.MemoryStorage()
        rt = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                              capacity_per_shard=16)
        ref = rt.actor(TCounterGrain, "player-7")
        assert int(await ref.bump(x=np.float32(3.5))) == 1
        kh = ref.key_hash
        bridge = ts.VectorStorageBridge(rt, TCounterGrain, storage)
        assert await bridge.flush([kh]) == 1
        rt2 = td.VectorRuntime(mesh=t_mesh(8, device="cpu"),
                               capacity_per_shard=16)
        assert await ts.VectorStorageBridge(
            rt2, TCounterGrain, storage).load([kh]) == [kh]
        assert float(rt2.table(TCounterGrain).read_row(kh)["last"]) == 3.5
        assert int(await rt2.actor(TCounterGrain, "player-7").bump(
            x=np.float32(0))) == 2

    async def test_records_stored_by_the_jax_bridge_load_in_the_port(self):
        jstore = js.MemoryStorage()
        jrt = _j_runtime(16)
        _bump_all(jrt, 16, 1.25, JCounterGrain)
        _bump_all(jrt, 16, 6.5, JCounterGrain)
        assert await js.VectorStorageBridge(
            jrt, JCounterGrain, jstore).flush(range(16)) == 16
        # the JAX package's blobs may be native hotwire frames, which the
        # port refuses; they cross as values
        tstore = ts.MemoryStorage()
        for key, (blob, etag) in jstore._data.items():
            tstore._data[key] = (tser.serialize(jser.deserialize(blob)),
                                 etag)
        rt = _runtime(16)
        loaded = await ts.VectorStorageBridge(
            rt, TCounterGrain, tstore).load(range(16))
        assert loaded == list(range(16))
        _assert_same_rows(_rows(jrt.table(JCounterGrain)),
                          _rows(rt.table(TCounterGrain)))
        out = _bump_all(rt, 16, 0.0)
        assert np.array_equal(np.asarray(out),
                              _bump_all(jrt, 16, 0.0, JCounterGrain))
