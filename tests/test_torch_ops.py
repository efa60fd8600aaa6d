"""Parity of the port's hot ops (orleans_tpu_torch.ops) with the JAX
package's (orleans_tpu.ops), on the CPU.

The same inputs, made with numpy from a seed, go through both packages.
The JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own tests do; the port's side runs the plain versions of its
CUDA kernels (a CPU tensor never reaches a kernel).

Tolerance: integer, bool and rank outputs match exactly. Float segment
sums match within 1e-6 of the per-segment sum of |values|, because the
two packages add in different orders (both accumulate in float32), plus
one unit in the last place of the output dtype, because each float32 sum
is rounded once more when cast back to that dtype (float16 here).
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.ops import hash_probe as jhp
from orleans_tpu.ops import route as jroute
from orleans_tpu.ops import segment_reduce as jseg
from orleans_tpu_torch.ops import hash_probe as thp
from orleans_tpu_torch.ops import route as troute
from orleans_tpu_torch.ops import segment_reduce as tseg
from orleans_tpu_torch.parallel import make_mesh

FLOAT_RTOL = 1e-6  # of sum |values| per segment: summation order differs


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close_sums(got, want, values, ids, S):
    """|got - want| <= FLOAT_RTOL * per-segment sum of |values|."""
    v = np.abs(np.asarray(values, np.float64))
    v = v if v.ndim == 2 else v[:, None]
    scale = np.zeros((S, v.shape[1]))
    ok = (ids >= 0) & (ids < S)
    np.add.at(scale, ids[ok], v[ok])
    scale = scale.reshape(np.shape(want))
    ulp = np.spacing(np.abs(np.asarray(want))).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= FLOAT_RTOL * scale + ulp).all(), float(err.max())


# ---------------------------------------------------------------------------
# K1: segment_sum
# ---------------------------------------------------------------------------

SEG_CASES = [
    # (B, S, D, dtype, id range low) — ragged B, out-of-range ids, 1-D
    (513, 8, 5, np.float32, -2),
    (1024, 300, None, np.int32, -1),
    (257, 7, None, np.float32, -3),
    (640, 40, 2, np.int32, 0),
    (96, 5, None, np.float16, -1),
]


def _seg_inputs(B, S, D, dtype, lo, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B,) if D is None else (B, D)
    if np.issubdtype(dtype, np.integer):
        v = rng.integers(-1000, 1000, shape).astype(dtype)
    else:
        v = rng.normal(size=shape).astype(dtype)
    ids = rng.integers(lo, S + 2, B).astype(np.int32)
    return v, ids


@pytest.mark.parametrize("B,S,D,dtype,lo", SEG_CASES)
def test_segment_sum_ref_matches_jax(B, S, D, dtype, lo):
    v, ids = _seg_inputs(B, S, D, dtype, lo)
    ref = tseg.segment_sum_ref(_t(v), _t(ids), S).numpy()
    assert ref.dtype == v.dtype and ref.shape == (S,) + v.shape[1:]
    jv, jids = jnp.asarray(v), jnp.asarray(ids)
    pallas = np.asarray(jseg.segment_sum_pallas(
        jv, jids, S, block_s=64, block_b=128, interpret=True))
    onehot = np.asarray(jseg.segment_sum_onehot(jv, jids, S))
    cpu = np.asarray(jseg.segment_sum(jv, jids, S))
    port_cpu = tseg.segment_sum(_t(v), _t(ids), S).numpy()
    port_onehot = tseg.segment_sum_onehot(_t(v), _t(ids), S).numpy()
    others = [pallas, onehot, port_cpu, port_onehot]
    if dtype != np.float16:
        # the JAX package's CPU path is a scatter-add in the input dtype:
        # a float16 accumulator is another contract than K1's float32 one
        others.append(cpu)
    for other in others:
        if np.issubdtype(dtype, np.integer):
            np.testing.assert_array_equal(ref, other)
        else:
            _close_sums(ref, other, v, ids, S)


@pytest.mark.parametrize("D", [None, 3])
def test_segment_sum_sharded_is_per_row(D):
    rng = np.random.default_rng(5)
    n, B, S = 4, 200, 11
    shape = (n, B) if D is None else (n, B, D)
    v = rng.integers(0, 50, shape).astype(np.int32)
    ids = rng.integers(-1, S + 1, (n, B)).astype(np.int32)
    got = tseg.segment_sum(_t(v), _t(ids), S).numpy()
    assert got.shape == (n, S) + v.shape[2:]
    for s in range(n):
        want = np.asarray(jseg.segment_sum(jnp.asarray(v[s]),
                                           jnp.asarray(ids[s]), S))
        np.testing.assert_array_equal(got[s], want)


def test_segment_sum_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tseg.segment_sum(torch.zeros(2, 3, 4, 5), torch.zeros(2, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        tseg.segment_sum(torch.zeros(5), torch.zeros(4, dtype=torch.int32), 3)


# K1's launch plan at the edge shapes: (rows, B, D, S). The kernel
# (csrc/segment_sum.cu) gives block b of row r the lanes [b * chunk,
# min(B, (b + 1) * chunk)) and, when a row has several blocks, indexes
# counter word r and partial word (r * bpr + b) * S * D + c.
SEG_PLAN_CASES = [
    (8, 156_256, 1, 128),   # the bench's fan-in
    (3, 10_001, 1, 50),     # odd B: rows start off 16-byte alignment
    (5, 777, 3, 20),        # ragged, D > 1
    (1, 1 << 20, 1, 2),     # one row of 1M lanes
    (1, 5_000, 1, 1_000),   # S = 1000
    (1, 20_000, 8, 4_096),  # S * D = 32,768
    (2, 0, 1, 3),           # no lanes: one block a row writes zeros
]


@pytest.mark.parametrize("rows,B,D,S", SEG_PLAN_CASES)
def test_segment_sum_plan_covers_the_rows(rows, B, D, S):
    plan = tseg.segment_sum_plan(rows, B, D, S, n_sms=132)
    chunk, bpr = plan.chunk, plan.blocks_per_row
    assert chunk >= 4 and chunk % 4 == 0 and bpr >= 1
    assert chunk * bpr >= B and (B == 0 or chunk * (bpr - 1) < B)
    assert chunk * D < 2**31 and 4 * S * D <= 232448 - 1024
    assert bpr * rows <= 132 or bpr == 1  # at most one block an SM
    if bpr == 1:
        assert plan.counter_words == plan.partial_words == 0
    else:
        assert rows - 1 < plan.counter_words
        last = ((rows - 1) * bpr + bpr - 1) * S * D + S * D - 1
        assert last < plan.partial_words
    with pytest.raises(ValueError):
        tseg.segment_sum_plan(rows, B, D, 60_000)


# ---------------------------------------------------------------------------
# masked_reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.bool_, np.float32])
def test_masked_reduce_matches_jax(op, dtype):
    rng = np.random.default_rng(7)
    shape = (3, 16, 2)
    if dtype == np.bool_:
        v = rng.random(shape) < 0.5
    elif dtype == np.int32:
        v = rng.integers(-500, 500, shape).astype(np.int32)
    else:
        v = rng.normal(size=shape).astype(np.float32)
    valid = rng.random((3, 16)) < 0.7
    want = np.asarray(jseg.masked_reduce(jnp.asarray(v), jnp.asarray(valid),
                                         op=op))
    got = tseg.masked_reduce(_t(v), _t(valid), op=op).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.float32 and op == "sum":
        np.testing.assert_allclose(got, want,
                                   atol=FLOAT_RTOL * np.abs(v).sum())
    else:
        np.testing.assert_array_equal(got, want)


def test_masked_reduce_dict_and_all_masked():
    vals = {"a": np.ones((2, 4, 3), np.float32),
            "b": np.full((2, 4), 2, np.int32)}
    m = np.ones((2, 4), bool)
    m[0, 0] = False
    out = tseg.masked_reduce({k: _t(v) for k, v in vals.items()}, _t(m))
    np.testing.assert_array_equal(out["a"].numpy(), [7.0] * 3)
    assert int(out["b"]) == 14 and out["b"].dtype == torch.int32
    none = torch.zeros((1, 2), dtype=torch.bool)
    assert int(tseg.masked_reduce(torch.tensor([[3, 4]], dtype=torch.int32),
                                  none, "max")) == np.iinfo(np.int32).min
    with pytest.raises(ValueError):
        tseg.masked_reduce(torch.ones(1, 1), torch.ones(1, 1).bool(), "median")
    assert tseg.host_fold("mean") is jseg.host_fold("mean")
    assert tseg.REDUCE_OPS == jseg.REDUCE_OPS


# ---------------------------------------------------------------------------
# K2: rank_by_dest, rank_dense_keys
# ---------------------------------------------------------------------------

RANK_CASES = [(300, 9), (1024, 65)]  # pairwise and one-hot regimes


@pytest.mark.parametrize("B,S", RANK_CASES)
def test_rank_by_dest_ref_matches_jax(B, S):
    rng = np.random.default_rng(B * 31 + S)
    d = rng.integers(0, S, B).astype(np.int32)
    ref = troute.rank_by_dest_ref(_t(d), S).numpy()
    assert ref.dtype == np.int32
    jd = jnp.asarray(d)
    for want in (
            jroute.rank_by_dest(jd, S, use_pallas=True, block=128,
                                interpret=True),
            jroute.rank_by_dest(jd, S, use_pallas=False),
            jroute.rank_dense_keys(jd)):
        np.testing.assert_array_equal(ref, np.asarray(want))
    np.testing.assert_array_equal(troute.rank_dense_keys(_t(d)).numpy(), ref)
    np.testing.assert_array_equal(troute.rank_by_dest(_t(d), S).numpy(), ref)


@pytest.mark.parametrize("dest", ["one", "distinct"])
def test_rank_edge_cases(dest):
    B = 600
    d = np.zeros(B, np.int32) if dest == "one" else np.arange(B, dtype=np.int32)
    S = int(d.max()) + 1
    want = np.arange(B) if dest == "one" else np.zeros(B)
    np.testing.assert_array_equal(troute.rank_by_dest_ref(_t(d), S).numpy(), want)
    np.testing.assert_array_equal(troute.rank_dense_keys(_t(d)).numpy(), want)


def test_rank_sharded_is_per_row():
    rng = np.random.default_rng(11)
    d = rng.integers(0, 5, (3, 700)).astype(np.int32)
    got = troute.rank_by_dest(_t(d), 5).numpy()
    for s in range(3):
        np.testing.assert_array_equal(
            got[s], np.asarray(jroute.rank_dense_keys(jnp.asarray(d[s]))))


# K2's launch plan at the edge shapes: (rows, B, S, max_cluster). The
# kernel (csrc/rank_by_dest.cu) gives block q of cluster k of a row the
# tile (k * cluster_size + q) of 512 * 16 lanes, holds the tile, per-warp
# counts and the cluster's totals in shared memory, and, when a row has
# several clusters, indexes scratch words 0 and 1 (ticket, done count) and
# 2 + (r * clusters_per_row + k) * S + c.
RANK_PLAN_CASES = [
    (8, 131_072, 9, 16),    # the bench's route
    (8, 131_072, 9, 8),     # where the card holds no cluster of 16
    (5, 1_001, 7, 16),      # odd B
    (3, 300_001, 5, 16),    # odd B, several clusters a row
    (1, 1 << 20, 2, 16),    # one row of 1M lanes
    (1, 1_000, 1_000, 16),  # S = 1000
    (8, 2, 9, 16),          # the sparse route's two lanes a shard
]


@pytest.mark.parametrize("rows,B,S,max_cluster", RANK_PLAN_CASES)
def test_rank_plan_covers_the_rows(rows, B, S, max_cluster):
    plan = troute.rank_plan(rows, B, S, max_cluster=max_cluster)
    cs, cpr, tile = plan.cluster_size, plan.clusters_per_row, 512 * 16
    assert troute.TILE == tile and 1 <= cs <= max_cluster and cpr >= 1
    assert tile * cs * cpr >= B and tile * cs * (cpr - 1) < B
    assert 4 * (tile + (16 + cs + 2) * S) <= 232448 - 1024
    assert 32 * 16 < 2**15 and S + 1 < 2**16  # the kernel's packed lanes
    if cpr == 1:
        assert plan.scratch_words == 0
    else:
        last = 2 + ((rows - 1) * cpr + cpr - 1) * S + S - 1
        assert last < plan.scratch_words
    with pytest.raises(ValueError):
        troute.rank_plan(rows, B, troute.max_dests() + 1)


# ---------------------------------------------------------------------------
# pack_by_dest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,n_dest,capacity", [
    (64, 4, 32),       # no overflow
    (300, 3, 40),      # overflow drops
    (40000, 5, 9000),  # past 32,768 lanes: the sort-based regime
])
def test_pack_by_dest_matches_jax(B, n_dest, capacity):
    rng = np.random.default_rng(B)
    dest = rng.integers(-1, n_dest + 1, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    payload = {"x": rng.integers(0, 1 << 30, B).astype(np.int32),
               "f": rng.normal(size=(B, 2)).astype(np.float32)}
    jp, jv, jd = jroute.pack_by_dest(
        jnp.asarray(dest), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in payload.items()}, n_dest, capacity)
    tp, tv, td = troute.pack_by_dest(
        _t(dest), _t(valid), {k: _t(v) for k, v in payload.items()},
        n_dest, capacity)
    assert td.dtype == torch.int32 and td.shape == ()
    assert int(td) == int(jd)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for k in payload:
        assert tp[k].shape == (n_dest, capacity) + payload[k].shape[1:]
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_pack_by_dest_sharded_is_per_row():
    rng = np.random.default_rng(3)
    n, B, n_dest, cap = 3, 200, 3, 50
    dest = rng.integers(0, n_dest, (n, B)).astype(np.int32)
    valid = rng.random((n, B)) < 0.9
    x = rng.integers(0, 100, (n, B)).astype(np.int32)
    tp, tv, td = troute.pack_by_dest(_t(dest), _t(valid), {"x": _t(x)},
                                     n_dest, cap)
    for s in range(n):
        jp, jv, jd = jroute.pack_by_dest(
            jnp.asarray(dest[s]), jnp.asarray(valid[s]),
            {"x": jnp.asarray(x[s])}, n_dest, cap)
        assert int(td[s]) == int(jd)
        np.testing.assert_array_equal(tv[s].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tp["x"][s].numpy(), np.asarray(jp["x"]))


# ---------------------------------------------------------------------------
# directory hash probe
# ---------------------------------------------------------------------------

def _hashes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [int(h) for h in rng.integers(1, 1 << 62, n, dtype=np.int64)]


def test_device_lookup64_matches_jax():
    keys = _hashes(160)
    jdir, tdir = jhp.DeviceDirectory64(64), \
        thp.DeviceDirectory64(64, device="cpu")
    for i, k in enumerate(keys):        # grows 64 → 512
        jdir.insert(k, i)
        tdir.insert(k, i)
    for k in keys[::3]:
        assert jdir.remove(k) and tdir.remove(k)
    for a, b in ((jdir.tk_lo, tdir.tk_lo), (jdir.tk_hi, tdir.tk_hi),
                 (jdir.tvals, tdir.tvals)):
        np.testing.assert_array_equal(a, b)
    assert tdir.capacity == jdir.capacity and tdir.count == jdir.count
    probe = keys + _hashes(50, seed=1)
    lo, hi = thp.split64(np.asarray(probe))
    jv, jf = jdir.lookup_batch(lo, hi)
    tv, tf = tdir.lookup_batch(lo, hi)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tv.dtype == torch.int32
    for k in probe[:40]:
        assert tdir.lookup(k) == jdir.lookup(k)


def test_device_directory31_matches_jax():
    rng = np.random.default_rng(2)
    keys = [int(k) for k in rng.integers(0, 2**31, 120)]
    jdir, tdir = jhp.DeviceDirectory(32), thp.DeviceDirectory(32, device="cpu")
    for i, k in enumerate(keys):
        jdir.insert(k, i)
        tdir.insert(k, i)
    for k in keys[1::4]:
        assert jdir.remove(k) == tdir.remove(k)
    np.testing.assert_array_equal(jdir.tkeys, tdir.tkeys)
    probe = np.asarray(keys + [5, 7, 2**31 - 1], np.int32)
    jv, jf = jdir.lookup_batch(probe)
    tv, tf = tdir.lookup_batch(probe)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    ta, tb = thp.build_directory_arrays({3: 1, 99: 2}, 8)
    ja, jb = jhp.build_directory_arrays({3: 1, 99: 2}, 8)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    with pytest.raises(ValueError):
        tdir.insert(2**31, 0)


# ---------------------------------------------------------------------------
# package boundaries
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import orleans_tpu_torch.runtime, orleans_tpu_torch.storage\n"
        "import orleans_tpu_torch.dispatch.hosting\n"
        "def bad():\n"
        "    return [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'orleans_tpu' or "
        "m.startswith('orleans_tpu.')]\n"
        "assert not bad(), bad()\n"
        "import orleans_tpu_torch\n"
        "for m in pkgutil.walk_packages(orleans_tpu_torch.__path__, "
        "'orleans_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not bad(), bad()\n"
        "for m in ('core.ids', 'config', 'observability', "
        "'observability.profiling', 'dispatch.reshard', "
        "'dispatch.replicated', 'dispatch.engine', 'dispatch.hosting', "
        "'interop', 'runtime.silo', 'runtime.dispatcher', "
        "'storage.checkpoint', 'directory.locator', "
        "'observability.ledger', 'observability.metrics', "
        "'observability.slo', 'observability.export', "
        "'runtime.multiloop', 'runtime.multiproc', 'streams.durable', "
        "'services.grain_service', 'reminders.table', 'reminders.service', "
        "'transactions.context', 'transactions.log', 'transactions.state', "
        "'transactions.manager', 'eventsourcing.journaled', "
        "'multicluster.gossip', 'multicluster.gsi'):\n"
        "    assert 'orleans_tpu_torch.' + m in sys.modules, m\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('orleans_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50


def test_port_sources_import_no_jax():
    """No file of the port imports jax, orbax or the JAX package, lazily
    or not."""
    pattern = re.compile(
        r"^\s*(import (jax|orbax|orleans_tpu)\b(?!_torch)"
        r"|from (jax|orbax|orleans_tpu)\b(?!_torch))", re.M)
    root = Path(__file__).resolve().parent.parent / "orleans_tpu_torch"
    files = sorted(root.rglob("*.py"))
    assert len(files) >= 50
    hits = [f"{f.relative_to(root)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_make_mesh_default_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert make_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
        with pytest.raises(RuntimeError):
            thp.DeviceDirectory64()
    mesh = make_mesh(8, device="cpu")
    assert mesh.n_shards == 8 and mesh.device == torch.device("cpu")


def test_cuda_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tseg.segment_sum(torch.zeros(4, device="meta"),
                         torch.zeros(4, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(ValueError):
        troute.rank_by_dest(torch.zeros(4, dtype=torch.int32, device="meta"), 2)
