"""Parity of the port's transactions (orleans_tpu_torch.transactions: the
ambient context, the commit logs, transactional state with wound-wait
entry, the sharded TM grains and the per-silo agent) with the JAX
package's, on the CPU: the scenarios of tests/test_transactions.py,
tests/test_transaction_recovery.py and tests/test_txn_wound_wait.py run
through each package one after the other, and what each observed must
be equal exactly.

Each package keeps module-level state (the wound registry of
``transactions/state.py``, the id counter of ``transactions/context.py``),
so the two silos of a pair never run at once. The copies of the three
recovery scenarios that kill a silo give the test cluster's client a 3 s
response timeout: a transfer whose silo was killed would otherwise wait
out the default 30 s (as the reference's copies do when the killed silo
hosts the mover); the scenario and what it checks are the same.

Grains of a pair are built by one factory per package; every async body
runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import json
import sqlite3
from types import SimpleNamespace

import pytest

import orleans_tpu.core.errors as jerr
import orleans_tpu.core.ids as jids
import orleans_tpu.runtime as jr
import orleans_tpu.runtime.grain as jgrain
import orleans_tpu.storage as js
import orleans_tpu.testing as jt
import orleans_tpu.transactions as jtx
import orleans_tpu.transactions.context as jctx
import orleans_tpu.transactions.state as jstate
import orleans_tpu_torch.core.errors as terr
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.runtime.grain as tgrain
import orleans_tpu_torch.storage as ts
import orleans_tpu_torch.testing as tt
import orleans_tpu_torch.transactions as ttx
import orleans_tpu_torch.transactions.context as tctx
import orleans_tpu_torch.transactions.state as tstate

TIMEOUT = 30
START = 1000
N_ACCOUNTS = 8


def _bank(tx):
    """tests/test_transactions.py's grains."""
    class AccountGrain(tx.TransactionalGrain):
        def __init__(self):
            self.balance = tx.TransactionalState("balance", default=100)

        @tx.transactional
        async def deposit(self, amount):
            v = await self.balance.get()
            await self.balance.set(v + amount)

        @tx.transactional
        async def withdraw(self, amount):
            v = await self.balance.get()
            if v < amount:
                raise ValueError("insufficient funds")
            await self.balance.set(v - amount)

        async def get_balance(self):
            return await self.balance.get()

        async def get_balance_in_txn(self):
            return await self.balance.get()

        async def set_in_txn(self, v):
            await self.balance.set(v)

        async def die(self):
            self.deactivate_on_idle()

    class BankGrain(tx.TransactionalGrain):
        @tx.transactional
        async def transfer(self, src, dst, amount, fail_after_debit=False):
            a = self.get_grain(AccountGrain, src)
            b = self.get_grain(AccountGrain, dst)
            await a.withdraw(amount)
            if fail_after_debit:
                raise RuntimeError("boom mid-transfer")
            await b.deposit(amount)

        @tx.transactional
        async def slow_double_read(self, src, dst, gate_key):
            a = self.get_grain(AccountGrain, src)
            b = self.get_grain(AccountGrain, dst)
            va = await a.get_balance_in_txn()
            vb = await b.get_balance_in_txn()
            await asyncio.sleep(0.3)
            await a.set_in_txn(va + 1)
            await b.set_in_txn(vb + 1)

    return AccountGrain, BankGrain


def _recovery(tx):
    """tests/test_transaction_recovery.py's grains."""
    class Account(tx.TransactionalGrain):
        def __init__(self):
            self.balance = tx.TransactionalState("balance", default=START)

        @tx.transactional
        async def deposit(self, n):
            await self.balance.set(await self.balance.get() + n)

        @tx.transactional
        async def withdraw(self, n):
            await self.balance.set(await self.balance.get() - n)

        async def get_balance(self):
            return await self.balance.get()

    class SlowCommitAccount(Account):
        gate = None

        async def _txn_commit(self, txn, version):
            if SlowCommitAccount.gate is not None:
                await SlowCommitAccount.gate.wait()
            return await super()._txn_commit(txn, version)

    class Mover(tx.TransactionalGrain):
        @tx.transactional
        async def transfer(self, cls_name, src, dst, n):
            cls = {"Account": Account,
                   "SlowCommitAccount": SlowCommitAccount}[cls_name]
            await self.get_grain(cls, src).withdraw(n)
            await self.get_grain(cls, dst).deposit(n)

    return Account, SlowCommitAccount, Mover


def _wound_wait(tx):
    """tests/test_txn_wound_wait.py's grains."""
    class Account(tx.TransactionalGrain):
        def __init__(self):
            self.balance = tx.TransactionalState("balance", default=START)

        @tx.transactional
        async def deposit(self, n):
            await self.balance.set(await self.balance.get() + n)

        @tx.transactional
        async def withdraw(self, n):
            await self.balance.set(await self.balance.get() - n)

        async def get_balance(self):
            return await self.balance.get()

    class SlowMover(tx.TransactionalGrain):
        @tx.transactional
        async def transfer_slow(self, src, dst, n, hold):
            await self.get_grain(Account, src).withdraw(n)
            await asyncio.sleep(hold)
            await self.get_grain(Account, dst).deposit(n)

        @tx.transactional
        async def transfer(self, src, dst, n):
            await self.get_grain(Account, src).withdraw(n)
            await self.get_grain(Account, dst).deposit(n)

    return Account, SlowMover


def _pkg(name, ids, err, rt, grain, storage, testing, tx, ctx, state):
    acct, bank = _bank(tx)
    racct, slow, mover = _recovery(tx)
    wacct, wmover = _wound_wait(tx)
    return SimpleNamespace(
        name=name, ids=ids, err=err, rt=rt, grain=grain, storage=storage,
        testing=testing, tx=tx, ctx=ctx, state=state,
        Account=acct, Bank=bank, RAccount=racct, SlowCommit=slow,
        Mover=mover, WAccount=wacct, WMover=wmover)


J = _pkg("jax", jids, jerr, jr, jgrain, js, jt, jtx, jctx, jstate)
T = _pkg("torch", tids, terr, tr, tgrain, ts, tt, ttx, tctx, tstate)

# the recovery grains' class names match the reference test's
for _p in (J, T):
    _p.RAccount.__name__ = _p.RAccount.__qualname__ = "Account"


async def _parity(scenario, *args):
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


# ---------------------------------------------------------------------------
# tests/test_transactions.py
# ---------------------------------------------------------------------------

async def _start(pkg, n=2, storage=None):
    fabric = pkg.rt.InProcFabric()
    storage = storage or pkg.storage.MemoryStorage()
    silos = []
    for i in range(n):
        b = (pkg.rt.SiloBuilder().with_name(f"t{i}").with_fabric(fabric)
             .add_grains(pkg.Account, pkg.Bank)
             .with_storage("Default", storage)
             .with_config(response_timeout=5.0))
        pkg.tx.add_transactions(b)
        silo = b.build()
        await silo.start()
        silos.append(silo)
    client = await pkg.rt.ClusterClient(fabric).connect()
    return silos, client


async def _stop_all(silos, client):
    await client.close_async()
    for s in silos:
        if s.status not in ("Stopped", "Dead"):
            await s.stop()


async def _balances(pkg, client, *keys):
    return tuple([await client.get_grain(pkg.Account, k).get_balance()
                  for k in keys])


async def _single_commit(pkg):
    silos, client = await _start(pkg)
    try:
        await client.get_grain(pkg.Account, "a1").deposit(50)
        return (await _balances(pkg, client, "a1"),
                silos[0].stats.get("transactions.committed")
                + silos[1].stats.get("transactions.committed"))
    finally:
        await _stop_all(silos, client)


async def test_single_grain_commit():
    assert await _parity(_single_commit) == ((150,), 1)


async def _atomic_transfer(pkg):
    silos, client = await _start(pkg)
    try:
        await client.get_grain(pkg.Bank, "bank").transfer("src1", "dst1", 30)
        return await _balances(pkg, client, "src1", "dst1")
    finally:
        await _stop_all(silos, client)


async def test_multi_grain_atomic_transfer():
    assert await _parity(_atomic_transfer) == (70, 130)


async def _failure_rolls_back(pkg):
    silos, client = await _start(pkg)
    try:
        bank = client.get_grain(pkg.Bank, "bank2")
        with pytest.raises(RuntimeError, match="boom"):
            await bank.transfer("src2", "dst2", 30, fail_after_debit=True)
        return await _balances(pkg, client, "src2", "dst2")
    finally:
        await _stop_all(silos, client)


async def test_failure_mid_transaction_rolls_back_all():
    assert await _parity(_failure_rolls_back) == (100, 100)


async def _insufficient_funds(pkg):
    silos, client = await _start(pkg)
    try:
        with pytest.raises(ValueError):
            await client.get_grain(pkg.Bank, "bank3").transfer(
                "src3", "dst3", 1000)
        return await _balances(pkg, client, "src3", "dst3")
    finally:
        await _stop_all(silos, client)


async def test_insufficient_funds_aborts_cleanly():
    assert await _parity(_insufficient_funds) == (100, 100)


async def _conflicts_serialize(pkg):
    silos, client = await _start(pkg)
    try:
        bank = client.get_grain(pkg.Bank, "bank4")
        rival = client.get_grain(pkg.Bank, "bank4-rival")
        slow = asyncio.ensure_future(bank.slow_double_read("src4", "dst4",
                                                           "g"))
        await asyncio.sleep(0.1)
        await rival.transfer("src4", "dst4", 10)
        await slow
        return await _balances(pkg, client, "src4", "dst4")
    finally:
        await _stop_all(silos, client)


async def test_conflicting_transactions_serialize():
    assert await _parity(_conflicts_serialize) == (91, 111)


async def _survives_deactivation(pkg):
    silos, client = await _start(pkg, storage=pkg.storage.MemoryStorage())
    try:
        acct = client.get_grain(pkg.Account, "a5")
        await acct.deposit(25)
        await acct.die()
        await asyncio.sleep(0.1)
        return await acct.get_balance()
    finally:
        await _stop_all(silos, client)


async def test_committed_state_survives_deactivation():
    assert await _parity(_survives_deactivation) == 125


async def _nested_required(pkg):
    silos, client = await _start(pkg)
    try:
        bank = client.get_grain(pkg.Bank, "bank6")
        await bank.transfer("src6", "dst6", 10)
        await bank.transfer("src6", "dst6", 10)
        return await _balances(pkg, client, "src6", "dst6")
    finally:
        await _stop_all(silos, client)


async def test_nested_required_joins_ambient_scope():
    assert await _parity(_nested_required) == (80, 120)


# ---------------------------------------------------------------------------
# tests/test_transaction_recovery.py
# ---------------------------------------------------------------------------

def _build(pkg, log_provider, storage=None):
    b = (pkg.testing.TestClusterBuilder(3)
         .add_grains(pkg.RAccount, pkg.SlowCommit, pkg.Mover)
         .with_transactions(log_provider=log_provider, shards=2)
         .with_config(response_timeout=2.0,
                      membership_probe_period=0.25,
                      membership_probe_timeout=1.0,
                      membership_missed_probes_limit=2,
                      membership_votes_needed=2,
                      membership_iam_alive_period=0.5,
                      membership_refresh_period=0.2))
    if storage is not None:
        b.with_storage(storage)
    return b.build()


def _gid(pkg, cls, key):
    return pkg.ids.GrainId.for_grain(pkg.grain.grain_type_of(cls), key)


def _tm_silo(pkg, cluster, shard):
    gid = _gid(pkg, pkg.tx.TransactionManagerGrain, shard)
    for silo in cluster.alive_silos:
        if silo.catalog.by_grain.get(gid):
            return silo
    return None


def _log_records(path):
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except FileNotFoundError:
        return []


async def _tm_kill_mid_load(pkg, tmp):
    log = pkg.tx.FileTransactionLog(str(tmp / f"{pkg.name}-txn.log"))
    cluster = _build(pkg, log)
    async with cluster:
        cluster.client.response_timeout = 3.0
        mover = cluster.grain(pkg.Mover, "m")
        for i in range(10):
            await mover.transfer("Account", i % N_ACCOUNTS,
                                 (i + 1) % N_ACCOUNTS, 1)
        victim = _tm_silo(pkg, cluster, 0) or _tm_silo(pkg, cluster, 1)
        pre_committed = [r for r in _log_records(log.path)
                         if r["d"] == "committed"]
        probe = pre_committed[0]

        async def load(wid):
            for i in range(20):
                try:
                    await mover.transfer(
                        "Account", (wid + i) % N_ACCOUNTS,
                        (wid + i + 3) % N_ACCOUNTS, 1)
                except Exception:  # noqa: BLE001 — in-flight txns may break
                    pass
                await asyncio.sleep(0)

        workers = [asyncio.ensure_future(load(w)) for w in range(4)]
        await asyncio.sleep(0.05)
        await cluster.kill_silo(victim)
        await cluster.wait_for_death(victim)
        await asyncio.gather(*workers)
        tm = cluster.client.get_grain(pkg.tx.TransactionManagerGrain,
                                      probe["s"])
        decision = await tm.decision_of(probe["t"])
        balances = await asyncio.gather(*(
            cluster.grain(pkg.RAccount, k).get_balance()
            for k in range(N_ACCOUNTS)))
        return (victim is not None, len(pre_committed) >= 10,
                decision is not None and decision[0] == "committed",
                _tm_silo(pkg, cluster, probe["s"]) is not victim,
                sum(balances))


async def test_tm_silo_kill_mid_load_file_log(tmp_path):
    assert await _parity(_tm_kill_mid_load, tmp_path) == (
        True, True, True, True, START * N_ACCOUNTS)


async def _await_logged_commit(path):
    for _ in range(200):
        if any(r["d"] == "committed" for r in _log_records(path)):
            return True
        await asyncio.sleep(0.02)
    return False


async def _tm_kill_in_doubt(pkg, tmp):
    log = pkg.tx.FileTransactionLog(str(tmp / f"{pkg.name}-txn.log"))
    cluster = _build(pkg, log)
    async with cluster:
        cluster.client.response_timeout = 3.0
        pkg.SlowCommit.gate = asyncio.Event()
        mover = cluster.grain(pkg.Mover, "m2")
        a0 = cluster.grain(pkg.SlowCommit, "a0")
        a1 = cluster.grain(pkg.SlowCommit, "a1")
        first = await a0.get_balance()
        transfer = asyncio.ensure_future(
            mover.transfer("SlowCommitAccount", "a0", "a1", 100))
        logged = await _await_logged_commit(log.path)
        rec = _log_records(log.path)[-1]
        victim = _tm_silo(pkg, cluster, rec["s"])
        await cluster.kill_silo(victim)
        await cluster.wait_for_death(victim)
        pkg.SlowCommit.gate.set()
        pkg.SlowCommit.gate = None
        try:
            await transfer
        except Exception:  # noqa: BLE001 — the root caller may see a break
            pass
        await asyncio.sleep(0.4)
        for _ in range(5):
            try:
                await mover.transfer("SlowCommitAccount", "a1", "a0", 10)
                break
            except pkg.err.TransactionAbortedError:
                await asyncio.sleep(0.05)
        else:
            raise AssertionError("fresh transfer kept aborting")
        return first, logged, (await a0.get_balance(),
                               await a1.get_balance())


async def test_tm_kill_after_logged_commit_in_doubt_participant(
        tmp_path, monkeypatch):
    for pkg in (J, T):
        monkeypatch.setattr(pkg.state, "PREPARE_LOCK_TTL", 0.3)
    got = await _parity(_tm_kill_in_doubt, tmp_path)
    assert got == (START, True, (START - 90, START + 90))


async def _participant_crash(pkg, tmp):
    log = pkg.tx.FileTransactionLog(str(tmp / f"{pkg.name}-txn.log"))
    cluster = _build(pkg, log, storage=pkg.storage.MemoryStorage())
    async with cluster:
        cluster.client.response_timeout = 3.0
        pkg.SlowCommit.gate = asyncio.Event()
        mover = cluster.grain(pkg.Mover, "m3")
        a0 = cluster.grain(pkg.SlowCommit, "b0")
        a1 = cluster.grain(pkg.SlowCommit, "b1")
        first = await a0.get_balance()
        transfer = asyncio.ensure_future(
            mover.transfer("SlowCommitAccount", "b0", "b1", 50))
        logged = await _await_logged_commit(log.path)
        gid = _gid(pkg, pkg.SlowCommit, "b0")
        victim = next(s for s in cluster.alive_silos
                      if s.catalog.by_grain.get(gid))
        await cluster.kill_silo(victim)
        await cluster.wait_for_death(victim)
        pkg.SlowCommit.gate.set()
        pkg.SlowCommit.gate = None
        try:
            await transfer
        except Exception:  # noqa: BLE001
            pass
        await asyncio.sleep(0.4)
        return first, logged, (await a0.get_balance(),
                               await a1.get_balance())


async def test_participant_crash_recovers_durable_prepare(tmp_path,
                                                          monkeypatch):
    for pkg in (J, T):
        monkeypatch.setattr(pkg.state, "PREPARE_LOCK_TTL", 0.3)
    got = await _parity(_participant_crash, tmp_path)
    assert got == (START, True, (START - 50, START + 50))


async def _late_abort(pkg, tmp):
    log = pkg.tx.SqliteTransactionLog(str(tmp / f"{pkg.name}-txn.db"))
    cluster = _build(pkg, log)
    async with cluster:
        tm = cluster.client.get_grain(pkg.tx.TransactionManagerGrain, 0)
        ok = await tm.commit_transaction("t-dup", [], 1e18)
        await tm.abort_transaction("t-dup", [])
        d = await tm.decision_of("t-dup")
    seq, decisions = await log.replay(0)
    log.close()
    return ok, tuple(d), tuple(decisions["t-dup"]), seq


async def test_late_abort_cannot_overwrite_commit(tmp_path):
    ok, d, replayed, _ = await _parity(_late_abort, tmp_path)
    assert ok is True and d[0] == "committed" and replayed[0] == "committed"


async def _log_roundtrip(pkg, tmp):
    out = []
    for kind, make in (
            ("file", lambda: pkg.tx.FileTransactionLog(
                str(tmp / f"{pkg.name}-a.log"))),
            ("sqlite", lambda: pkg.tx.SqliteTransactionLog(
                str(tmp / f"{pkg.name}-a.db")))):
        log = make()
        await log.append(1, "t1", "committed", 5)
        await log.append(1, "t2", "aborted", 0)
        await log.append(2, "t3", "committed", 6)
        out.append(await log.replay(1))
        await log.rewrite(1, {"t2": ("aborted", 0)}, seq=5)
        out.append(await log.replay(1))
        out.append(await log.replay(2))
        if kind == "file":
            out.append(_log_records(log.path))
        else:
            log.close()
            db = sqlite3.connect(str(tmp / f"{pkg.name}-a.db"))
            try:
                tables = [r[0] for r in db.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"
                    " ORDER BY name")]
                out.append({t: sorted(db.execute(f"SELECT * FROM {t}")
                                      .fetchall()) for t in tables})
            finally:
                db.close()
    return out


async def test_log_backends_roundtrip_and_compaction(tmp_path):
    """The replays, and the plain rows each backend leaves (the file
    log's JSON records, the SQLite tables), equal across the packages."""
    got = await _parity(_log_roundtrip, tmp_path)
    for i in (0, 4):
        assert got[i] == (5, {"t1": ("committed", 5), "t2": ("aborted", 0)})
        assert got[i + 1] == (5, {"t2": ("aborted", 0)})
        assert got[i + 2] == (6, {"t3": ("committed", 6)})


async def _first_decision_wins(pkg, tmp):
    out = []
    for make in (pkg.tx.InMemoryTransactionLog,
                 lambda: pkg.tx.FileTransactionLog(
                     str(tmp / f"{pkg.name}-d.log")),
                 lambda: pkg.tx.SqliteTransactionLog(
                     str(tmp / f"{pkg.name}-d.db"))):
        log = make()
        out.append((await log.decide(0, "tx", "committed", 7),
                    await log.decide(0, "tx", "aborted", 0),
                    (await log.replay(0))[1]["tx"],
                    await log.decide(0, "tx2", "aborted", 0),
                    await log.decide(0, "tx2", "committed", 9)))
        if hasattr(log, "close"):
            log.close()
    return out


async def test_decide_is_first_decision_wins_on_all_backends(tmp_path):
    got = await _parity(_first_decision_wins, tmp_path)
    want = (("committed", 7), ("committed", 7), ("committed", 7),
            ("aborted", 0), ("aborted", 0))
    assert [tuple(tuple(x) for x in row) for row in got] == [want] * 3


async def _no_join_trace(pkg, tmp):
    log = pkg.tx.FileTransactionLog(str(tmp / f"{pkg.name}-txn.log"))
    cluster = _build(pkg, log)
    async with cluster:
        acct = cluster.grain(pkg.RAccount, 0)
        first = await acct.get_balance()
        silo = cluster.alive_silos[0]
        vote = await silo.runtime_client.send_request(
            target_grain=_gid(pkg, pkg.RAccount, 0), grain_class=pkg.RAccount,
            interface_name="Account", method_name="_txn_prepare",
            args=("ghost-txn-never-joined",), kwargs={},
            is_always_interleave=True)
        return first, vote


async def test_prepare_refuses_txn_with_no_join_trace(tmp_path):
    assert await _parity(_no_join_trace, tmp_path) == (START, False)


# ---------------------------------------------------------------------------
# tests/test_txn_wound_wait.py
# ---------------------------------------------------------------------------

async def _ww_cluster(pkg):
    silo = pkg.tx.add_transactions(
        pkg.rt.SiloBuilder().with_name("ww").add_grains(
            pkg.WAccount, pkg.WMover)).build()
    await silo.start()
    client = await pkg.rt.ClusterClient(silo.fabric).connect()
    return silo, client


async def _opposite_order(pkg):
    silo, client = await _ww_cluster(pkg)
    try:
        m1 = client.get_grain(pkg.WMover, 1)
        m2 = client.get_grain(pkg.WMover, 2)
        await asyncio.gather(*(
            coro for i in range(25)
            for coro in (m1.transfer(0, 1, 1), m2.transfer(1, 0, 1))))
        return (await client.get_grain(pkg.WAccount, 0).get_balance()
                + await client.get_grain(pkg.WAccount, 1).get_balance(),
                silo.stats.get("transactions.committed") >= 50)
    finally:
        await client.close_async()
        await silo.stop()


async def test_opposite_order_transfers_no_deadlock_conservation():
    assert await _parity(_opposite_order) == (2 * START, True)


async def _older_wounds_younger(pkg):
    silo, client = await _ww_cluster(pkg)
    try:
        m1 = client.get_grain(pkg.WMover, 1)
        m2 = client.get_grain(pkg.WMover, 2)
        slow = asyncio.ensure_future(m2.transfer_slow(2, 3, 5, 0.05))
        await asyncio.sleep(0.01)
        await m1.transfer(2, 3, 7)
        await slow
        return (await client.get_grain(pkg.WAccount, 2).get_balance(),
                await client.get_grain(pkg.WAccount, 3).get_balance())
    finally:
        await client.close_async()
        await silo.stop()


async def test_older_transaction_wounds_younger_holder():
    assert await _parity(_older_wounds_younger) == (START - 12, START + 12)


async def _retry_keeps_priority(pkg):
    silo, client = await _ww_cluster(pkg)
    real_start = silo.transactions.start
    try:
        seen_ts = []

        def spying_start(timeout=10.0, priority_ts=None):
            info = real_start(timeout=timeout, priority_ts=priority_ts)
            seen_ts.append(info.ts)
            return info

        silo.transactions.start = spying_start
        calls = {"n": 0}

        class Flaky(pkg.tx.TransactionalGrain):
            @pkg.tx.transactional
            async def op(self):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise pkg.err.TransactionConflictError(
                        "injected conflict")
                return "ok"

        silo.registry.register(Flaky)
        out = await client.get_grain(Flaky, "f").op()
        return out, calls["n"], len(seen_ts) >= 2 and seen_ts[0] == seen_ts[1]
    finally:
        silo.transactions.start = real_start
        await client.close_async()
        await silo.stop()


async def test_conflict_retry_keeps_priority_ts():
    assert await _parity(_retry_keeps_priority) == ("ok", 2, True)


async def _interleave(pkg):
    class Parker(pkg.tx.TransactionalGrain):
        def __init__(self):
            self.state = pkg.tx.TransactionalState("s", default=0)
            self.gate = asyncio.Event()
            self.entered = asyncio.Event()

        @pkg.tx.transactional
        async def hold(self):
            await self.state.get()
            self.entered.set()
            await asyncio.wait_for(self.gate.wait(), 5)

        @pkg.tx.transactional
        async def quick(self):
            return "in"

        @pkg.grain.always_interleave
        async def release(self):
            self.gate.set()

    silo = pkg.tx.add_transactions(
        pkg.rt.SiloBuilder().with_name("il").add_grains(Parker)).build()
    await silo.start()
    client = await pkg.rt.ClusterClient(silo.fabric).connect()
    try:
        g = client.get_grain(Parker, "p")
        holder = asyncio.ensure_future(g.hold())
        acts = None
        for _ in range(200):
            await asyncio.sleep(0.005)
            acts = silo.catalog.by_grain.get(_gid(pkg, Parker, "p"))
            if acts and acts[0].grain_instance.entered.is_set():
                break
        quick = await asyncio.wait_for(g.quick(), timeout=1)
        await g.release()
        await holder
        return bool(acts), quick
    finally:
        await client.close_async()
        await silo.stop()


async def test_transactional_methods_interleave():
    assert await _parity(_interleave) == (True, "in")


async def _copy_isolates(pkg):
    class Holder(pkg.rt.Grain):
        def __init__(self):
            self.items = []

        @pkg.grain.always_interleave
        async def put(self, xs):
            self.items.append(xs)
            return xs

        @pkg.grain.always_interleave
        async def peek(self):
            return self.items[-1]

    class Caller(pkg.rt.Grain):
        async def drive(self):
            h = self.get_grain(Holder, "h")
            payload = [1, 2]
            await h.put(payload)
            payload.append(3)
            stored = await h.peek()
            seen = list(stored)
            stored.append(99)
            return seen, await h.peek()

    silo = pkg.rt.SiloBuilder().with_name("dc").add_grains(Holder,
                                                           Caller).build()
    await silo.start()
    client = await pkg.rt.ClusterClient(silo.fabric).connect()
    try:
        return await client.get_grain(Caller, "c").drive()
    finally:
        await client.close_async()
        await silo.stop()


async def test_direct_interleave_path_copy_isolates():
    assert await _parity(_copy_isolates) == ([1, 2], [1, 2])


async def _no_starvation(pkg):
    class Echo(pkg.rt.Grain):
        async def ping(self, x):
            return x

    silo = pkg.rt.SiloBuilder().with_name("fair").add_grains(Echo).build()
    await silo.start()
    client = await pkg.rt.ClusterClient(silo.fabric).connect()
    try:
        g = client.get_grain(Echo, 0)
        await g.ping(0)
        ticks = 0

        async def ticker():
            nonlocal ticks
            while True:
                ticks += 1
                await asyncio.sleep(0)

        t = asyncio.ensure_future(ticker())
        for i in range(2000):
            await g.ping(i)
        t.cancel()
        return ticks > 500
    finally:
        await client.close_async()
        await silo.stop()


async def test_tight_call_loop_does_not_starve_background_tasks():
    assert await _parity(_no_starvation) is True


def test_transaction_infos_are_alike():
    """The ambient context: a TransactionInfo's fields and the header it
    rides under are the same in both packages (its id counter is each
    package's own)."""
    a = jctx.TransactionInfo(id="t-1", deadline=5.0, ts=(1.0, "p", 1))
    b = tctx.TransactionInfo(id="t-1", deadline=5.0, ts=(1.0, "p", 1))
    assert jctx.TransactionInfo.__slots__ == tctx.TransactionInfo.__slots__
    assert [getattr(a, f) for f in a.__slots__] == \
        [getattr(b, f) for f in b.__slots__]
    assert jr.context.TXN_KEY == tr.context.TXN_KEY == "orleans.txn"
    assert jtx.__all__ == ttx.__all__
