"""Parity of the port's dispatch tick (orleans_tpu_torch.dispatch) with the
JAX package's (orleans_tpu.dispatch), on the CPU.

Each test builds the same grain in both packages, feeds both the same
seeded numpy inputs, and compares every result and every state row.
Tolerance: exact. All state and results here are integers, bools, or
float32 positions cast from float16 payloads, which both packages cast
the same way. The sink row (slot ``capacity``) is left out of state
comparisons: padding lanes all write there, in an undefined order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from orleans_tpu.dispatch import VectorGrain as JGrain
from orleans_tpu.dispatch import VectorRuntime as JRuntime
from orleans_tpu.dispatch import actor_method as j_method
from orleans_tpu.parallel import make_mesh as j_mesh
from orleans_tpu_torch.dispatch import VectorGrain as TGrain
from orleans_tpu_torch.dispatch import VectorRuntime as TRuntime
from orleans_tpu_torch.dispatch import actor_method as t_method
from orleans_tpu_torch.interop import state_from_numpy
from orleans_tpu_torch.parallel import make_mesh as t_mesh


class JPlayer(JGrain):
    STATE = {"pos": (jnp.float32, (2,)), "beats": (jnp.int32, ()),
             "game": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": jnp.zeros(2, jnp.float32), "beats": jnp.int32(0),
                "game": key_hash % 1024}

    @j_method(args={"pos": (jnp.float16, (2,))})
    def heartbeat(state, args):
        new = {"pos": args["pos"].astype(jnp.float32),
               "beats": state["beats"] + 1, "game": state["game"]}
        return new, {"game": new["game"], "beats": new["beats"]}

    @j_method(read_only=True)
    def peek(state, args):
        return state, state["beats"] * 2 + state["game"]

    @j_method
    def ping(state, args):
        return state, jnp.int32(7)

    @j_method(args={"pos": (jnp.float16, (2,))}, read_only=True)
    def probe(state, args):
        return state, state["game"] + (args["pos"][0] > 0.5)


class TPlayer(TGrain):
    STATE = {"pos": (torch.float32, (2,)), "beats": (torch.int32, ()),
             "game": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": key_hash.new_zeros(2, dtype=torch.float32),
                "beats": torch.zeros_like(key_hash),
                "game": key_hash % 1024}

    @t_method(args={"pos": (torch.float16, (2,))})
    def heartbeat(state, args):
        new = {"pos": args["pos"].to(torch.float32),
               "beats": state["beats"] + 1, "game": state["game"]}
        return new, {"game": new["game"], "beats": new["beats"]}

    @t_method(read_only=True)
    def peek(state, args):
        return state, state["beats"] * 2 + state["game"]

    @t_method
    def ping(state, args):
        # an unbatched constant: vmap expands it to one value per lane
        return state, torch.tensor(7, dtype=torch.int32)

    @t_method(args={"pos": (torch.float16, (2,))}, read_only=True)
    def probe(state, args):
        return state, state["game"] + (args["pos"][0] > 0.5)


def _pair(n_shards, capacity, n_players):
    jrt = JRuntime(mesh=j_mesh(n_shards), capacity_per_shard=capacity)
    trt = TRuntime(mesh=t_mesh(n_shards, device="cpu"),
                   capacity_per_shard=capacity)
    jrt.table(JPlayer).ensure_dense(n_players)
    trt.table(TPlayer).ensure_dense(n_players)
    return jrt, trt


def _same_state(jtbl, ttbl):
    assert jtbl.capacity == ttbl.capacity
    js, ts = jtbl.snapshot(), ttbl.snapshot()
    assert js.keys() == ts.keys()
    C = jtbl.capacity
    for k in js:
        assert ts[k].dtype == js[k].dtype, k
        np.testing.assert_array_equal(ts[k][:, :C], js[k][:, :C], err_msg=k)


def _same_tree(t, j):
    if isinstance(j, dict):
        assert t.keys() == j.keys()
        for k in j:
            _same_tree(t[k], j[k])
        return
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j)


def _pos(rng, *shape):
    return rng.random((*shape, 2), dtype=np.float32).astype(np.float16)


class TEntryPlayer(TGrain):
    """The port of ``__graft_entry__._player_class()``."""

    STATE = {"pos": (torch.float32, (2,)), "beats": (torch.int32, ()),
             "game": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": key_hash.new_zeros(2, dtype=torch.float32),
                "beats": torch.zeros_like(key_hash), "game": key_hash % 64}

    @t_method(args={"pos": (torch.float16, (2,))})
    def heartbeat(state, args):
        new = {"pos": args["pos"].to(torch.float32),
               "beats": state["beats"] + 1, "game": state["game"]}
        return new, {"game": new["game"], "beats": new["beats"]}


@pytest.mark.parametrize("n_shards", [1, 8])
def test_entry_tick(n_shards):
    """The ``__graft_entry__.entry()`` tick: 256 players, one batched
    heartbeat through the raw kernel, here with random payloads and a
    random fresh mask."""
    n_players = 256
    if n_shards == 1:
        jfn, (jstate, js, jk, _, jv, _) = __graft_entry__.entry()
    else:
        JEntry = __graft_entry__._player_class()
        jrt = JRuntime(mesh=j_mesh(n_shards),
                       capacity_per_shard=n_players // n_shards)
        jtbl = jrt.table(JEntry)
        jtbl.ensure_dense(n_players)
        jplan = jrt.make_dense_plan(JEntry, np.arange(n_players))
        js, jk, jv, _ = jplan.device_operands(jtbl._put)
        jfn = jrt._kernel(JEntry, "heartbeat", jplan.B)
        jstate = jtbl.state
    trt = TRuntime(mesh=t_mesh(n_shards, device="cpu"),
                   capacity_per_shard=n_players // n_shards)
    ttbl = trt.table(TEntryPlayer)
    ttbl.ensure_dense(n_players)
    tplan = trt.make_dense_plan(TEntryPlayer, np.arange(n_players))
    assert js.shape == (n_shards, tplan.B)
    # key hashes reach the device as int32, as in the JAX package
    assert tplan.khash_b.dtype == np.int32
    np.testing.assert_array_equal(tplan.khash_b, np.asarray(jk))
    rng = np.random.default_rng(n_shards)
    pos = _pos(rng, n_shards, tplan.B)
    fresh = rng.random((n_shards, tplan.B)) < 0.5
    jnew, jres = jfn(jstate, js, jk, jnp.asarray(fresh), jv,
                     {"pos": jnp.asarray(pos)})
    ts, tk, tv, _ = tplan.device_operands(trt.device)
    tfn = trt._kernel(TEntryPlayer, "heartbeat", tplan.B)
    tnew, tres = tfn(ttbl.state, ts, tk, torch.from_numpy(fresh), tv,
                     {"pos": torch.from_numpy(pos)})
    assert tnew is ttbl.state  # in place, where JAX donates
    _same_tree(tres, jres)
    C = ttbl.capacity
    for k, v in jnew.items():
        np.testing.assert_array_equal(tnew[k].numpy()[:, :C],
                                      np.asarray(v)[:, :C], err_msg=k)


@pytest.mark.parametrize("plan_kind", ["identity", "permuted"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_call_batch_fresh_and_plans(plan_kind, n_shards):
    n_players = 96
    jrt, trt = _pair(n_shards, 32, n_players)
    rng = np.random.default_rng(7)
    if plan_kind == "identity":
        keys = np.arange(n_players)
    else:
        keys = rng.permutation(n_players)[:70]
    jplan = jrt.make_dense_plan(JPlayer, keys)
    tplan = trt.make_dense_plan(TPlayer, keys)
    assert jplan.identity == tplan.identity == (plan_kind == "identity")
    assert jrt._plan_contiguous(jrt.table(JPlayer), jplan) == \
        trt._plan_contiguous(trt.table(TPlayer), tplan)
    operands = [t.clone() for t in tplan.device_operands(trt.device)]
    for tick in range(3):
        pos = _pos(rng, keys.shape[0])
        # tick 0: auto-activation; tick 1: an explicit fresh mask
        # (re-activates some rows); tick 2: steady state
        fresh = (rng.random(keys.shape[0]) < 0.3) if tick == 1 else None
        jout = jrt.call_batch(JPlayer, "heartbeat", keys, {"pos": pos},
                              fresh=fresh, plan=jplan)
        tout = trt.call_batch(TPlayer, "heartbeat", keys, {"pos": pos},
                              fresh=fresh, plan=tplan)
        _same_tree(tout, jout)
        _same_state(jrt.table(JPlayer), trt.table(TPlayer))
    # the cached plan operands are shared by every tick: never written
    for before, after in zip(operands, tplan.device_operands(trt.device)):
        assert torch.equal(before, after)
    np.testing.assert_array_equal(trt.table(TPlayer).dense_active,
                                  jrt.table(JPlayer).dense_active)
    jp = jrt.call_batch(JPlayer, "ping", keys, {}, plan=jplan)
    tp = trt.call_batch(TPlayer, "ping", keys, {}, plan=tplan)
    _same_tree(tp, jp)
    _same_state(jrt.table(JPlayer), trt.table(TPlayer))
    assert trt.messages_processed == jrt.messages_processed


@pytest.mark.parametrize("keys_kind", ["identity", "permuted"])
def test_call_batch_rounds_and_read_only(keys_kind):
    n_shards, n_players, K = 2, 60, 3
    jrt, trt = _pair(n_shards, 32, n_players)
    rng = np.random.default_rng(3)
    keys = np.arange(n_players) if keys_kind == "identity" \
        else rng.permutation(n_players)
    pos = _pos(rng, K, n_players)
    jout = jrt.call_batch_rounds(JPlayer, "heartbeat", keys, {"pos": pos})
    tout = trt.call_batch_rounds(TPlayer, "heartbeat", keys, {"pos": pos})
    _same_tree(tout, jout)
    assert (tout["beats"][-1] == K).all()
    _same_state(jrt.table(JPlayer), trt.table(TPlayer))
    # device-resident results [K, n, B] and a second scan over live rows
    jdev = jrt.call_batch_rounds(JPlayer, "heartbeat", keys, {"pos": pos},
                                 device_results=True)
    tdev = trt.call_batch_rounds(TPlayer, "heartbeat", keys, {"pos": pos},
                                 device_results=True)
    _same_tree(tdev, jdev)
    assert tdev["beats"].shape[:2] == (K, n_shards)
    # read-only: results but no write-back
    before = trt.table(TPlayer).snapshot()
    jro = jrt.call_batch(JPlayer, "peek", keys, {})
    tro = trt.call_batch(TPlayer, "peek", keys, {})
    _same_tree(tro, jro)
    after = trt.table(TPlayer).snapshot()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])
    assert trt.ticks == jrt.ticks


@pytest.mark.parametrize("n_shards", [1, 2])
def test_read_only_rounds_on_fresh_keys(n_shards):
    """A read-only scan over never-activated keys sees initialized rows
    but commits nothing, in both packages."""
    n_players, K = 24, 2
    jrt, trt = _pair(n_shards, 16, n_players)
    keys = np.arange(n_players)[::-1].copy()
    pos = _pos(np.random.default_rng(6), K, n_players)
    jout = jrt.call_batch_rounds(JPlayer, "probe", keys, {"pos": pos})
    tout = trt.call_batch_rounds(TPlayer, "probe", keys, {"pos": pos})
    _same_tree(tout, jout)
    _same_state(jrt.table(JPlayer), trt.table(TPlayer))
    assert not trt.table(TPlayer).state["game"].any()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_device_staged_rounds_identity_plan(n_shards):
    n_players, K = 50, 2
    jrt, trt = _pair(n_shards, 64, n_players)
    keys = np.arange(n_players)
    rng = np.random.default_rng(4)
    pos = _pos(rng, K, n_players)
    jout = jrt.call_batch_rounds(JPlayer, "heartbeat", keys,
                                 {"pos": jnp.asarray(pos)})
    tout = trt.call_batch_rounds(TPlayer, "heartbeat", keys,
                                 {"pos": torch.from_numpy(pos)})
    _same_tree(tout, jout)
    _same_state(jrt.table(JPlayer), trt.table(TPlayer))


def test_grow_keeps_rows():
    jrt, trt = _pair(2, 8, 16)
    keys = np.arange(16)
    pos = _pos(np.random.default_rng(5), 16)
    jrt.call_batch(JPlayer, "heartbeat", keys, {"pos": pos})
    trt.call_batch(TPlayer, "heartbeat", keys, {"pos": pos})
    jrt.table(JPlayer).grow(20)
    trt.table(TPlayer).grow(20)
    assert trt.table(TPlayer).capacity == 32
    assert trt.table(TPlayer).free == jrt.table(JPlayer).free
    _same_state(jrt.table(JPlayer), trt.table(TPlayer))
    jout = jrt.call_batch(JPlayer, "heartbeat", keys, {"pos": pos})
    tout = trt.call_batch(TPlayer, "heartbeat", keys, {"pos": pos})
    _same_tree(tout, jout)
    assert (tout["beats"] == 2).all()
    assert trt.table(TPlayer).read_row(5)["beats"] == 2


def test_hashed_regime_matches_jax():
    jrt = JRuntime(mesh=j_mesh(4), capacity_per_shard=4)
    trt = TRuntime(mesh=t_mesh(4, device="cpu"), capacity_per_shard=4)
    jt, tt = jrt.table(JPlayer), trt.table(TPlayer)
    hashes = [(k * 2654435761) & ((1 << 62) - 1) for k in range(1, 30)]
    for h in hashes:                    # grows past 4 slots per shard
        assert jt.lookup_or_allocate(h) == tt.lookup_or_allocate(h)
    for h in hashes[::5]:
        assert jt.release(h) and tt.release(h)
    assert not tt.release(hashes[0])
    assert tt.capacity == jt.capacity and tt.free == jt.free
    assert tt.key_to_slot == jt.key_to_slot
    np.testing.assert_array_equal(tt.device_dir.tk_lo, jt.device_dir.tk_lo)
    assert tt.lookup(hashes[1]) == jt.lookup(hashes[1])
    with pytest.raises(RuntimeError):
        tt.ensure_dense(8)


def test_interop_moves_jax_state_then_both_tick():
    """JAX state carried into the port by interop, then the same ticks in
    both packages."""
    n_shards, n_players = 4, 40
    jrt, trt = _pair(n_shards, 16, n_players)
    keys = np.arange(n_players)
    rng = np.random.default_rng(9)
    jrt.call_batch_rounds(JPlayer, "heartbeat", keys,
                          {"pos": _pos(rng, 3, n_players)})
    snap = jrt.table(JPlayer).snapshot()
    moved = state_from_numpy(snap, "cpu")
    assert moved["pos"].dtype == torch.float32
    assert moved["beats"].dtype == torch.int32
    ttbl = trt.table(TPlayer)
    ttbl.restore(moved)
    ttbl.mark_dense_active(keys)
    jrt.table(JPlayer).mark_dense_active(keys)
    _same_state(jrt.table(JPlayer), ttbl)
    for _ in range(2):
        pos = _pos(rng, n_players)
        jout = jrt.call_batch(JPlayer, "heartbeat", keys, {"pos": pos})
        tout = trt.call_batch(TPlayer, "heartbeat", keys, {"pos": pos})
        _same_tree(tout, jout)
    assert (tout["beats"] == 5).all()
    _same_state(jrt.table(JPlayer), ttbl)
    # restore also takes the numpy snapshot itself, and checks shapes
    ttbl.restore(snap)
    with pytest.raises(ValueError):
        ttbl.restore({"beats": snap["beats"][:, :3]})


def test_duplicate_keys_refused():
    _, trt = _pair(1, 8, 8)
    with pytest.raises(ValueError):
        trt.make_dense_plan(TPlayer, np.array([1, 1]))
    with pytest.raises(TypeError):
        trt.call_batch(TPlayer, "heartbeat", np.arange(2), {"x": np.zeros(2)})


@pytest.mark.parametrize("mask", ["numpy", "tensor"])
def test_call_batch_device_counts_host_and_device_masks(mask):
    """call_batch_device takes numpy or tensor operands, as the reference
    does: a numpy valid mask is counted into messages_processed, a mask on
    the device adds its lanes to exchange_lanes (counting it would sync).
    Results and state equal the reference's."""
    n_shards, B = 2, 8
    jrt, trt = _pair(n_shards, 16, 32)
    rng = np.random.default_rng(11)
    slots = np.tile(np.arange(B, dtype=np.int32), (n_shards, 1))
    valid = rng.random((n_shards, B)) < 0.6
    slots[~valid] = 16  # idle lanes aim at the sink row
    khash = (np.arange(n_shards)[:, None] * 16 + slots).astype(np.int32)
    fresh = valid.copy()
    pos = _pos(rng, n_shards, B)

    def ops(as_tensor):
        conv = torch.from_numpy if as_tensor else jnp.asarray
        return [conv(a) for a in (slots, khash, fresh, valid)], \
            {"pos": conv(pos)}

    jops, jargs = (slots, khash, fresh, valid), {"pos": pos}
    if mask == "tensor":
        jops, jargs = ops(False)
    jres = jrt.call_batch_device(JPlayer, "heartbeat", *jops, jargs)
    tops, targs = (slots, khash, fresh, valid), {"pos": pos}
    if mask == "tensor":
        tops, targs = ops(True)
    tres = trt.call_batch_device(TPlayer, "heartbeat", *tops, targs)
    for k in jres:
        np.testing.assert_array_equal(tres[k].numpy()[valid],
                                      np.asarray(jres[k])[valid])
    _same_state(jrt.table(JPlayer), trt.table(TPlayer))
    assert trt.messages_processed == jrt.messages_processed
    assert trt.exchange_lanes == jrt.exchange_lanes
    if mask == "numpy":
        assert trt.messages_processed == int(valid.sum())
        assert trt.exchange_lanes == 0
    else:
        assert trt.messages_processed == 0
        assert trt.exchange_lanes == n_shards * B
