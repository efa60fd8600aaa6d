"""Host the device tier inside a silo (the two-tier catalog of SURVEY §7
hard parts #1, and the north-star interception: the silo's message loop
hands vector-interface requests to the batched kernel engine instead of
per-activation turns).

``add_vector_grains(builder, PlayerGrain, ...)`` installs a VectorRuntime
on the silo and registers each class's interface; after that, ordinary
clients call device-tier actors exactly like host grains —

    client.get_grain(PlayerGrain, 42).heartbeat(pos=...)

— and concurrent calls from any number of clients coalesce into per-tick
kernels. Gateway affinity (target-grain-hash routing in the client message
centers) keeps one key's calls on one silo, so per-silo tables act as the
cluster's key partition without a directory entry per actor.

The port's copy of ``orleans_tpu.dispatch.hosting``, over the port's
engine and the port's host tier (``orleans_tpu_torch.runtime``): snapshots
are ``torch.save`` directories (storage.checkpoint), and ``mesh=None``
means CUDA or raise, as everywhere in the port. Its ownership sweep keeps
the rows of keys the ring gives the silo's own worker processes.
"""

from __future__ import annotations

from ..parallel.mesh import refuse_on_group
from .engine import VectorRuntime
from .vector_grain import VectorGrain

__all__ = ["add_vector_grains"]


def add_vector_grains(builder, *grain_classes: type[VectorGrain],
                      mesh=None, capacity_per_shard: int = 1024,
                      dense: dict[type, int] | None = None,
                      options=None, storage=None,
                      flush_period: float = 1.0,
                      checkpoint_dir: str | None = None,
                      checkpoint_period: float = 30.0,
                      checkpoint_keep: int = 3):
    """Register device-tier grain classes on a SiloBuilder.

    ``dense``: optional {class: n} pre-provisioning keys 0..n-1 with the
    zero-shuffle dense mapping (the bulk regime). ``options``: a
    config.DispatchOptions group (overrides capacity_per_shard).

    ``storage``: a GrainStorage provider enabling write-behind persistence
    (the TpuGrainStorage of the north-star design): keys written by ticks
    are tracked and their device rows flushed every ``flush_period``
    seconds via storage.checkpoint.VectorStorageBridge, with a final flush
    at silo stop. Resume stays per-actor-lazy: ``silo.vector_bridges[cls]
    .load(keys)`` rehydrates rows (the virtual-actor rebuild contract).

    ``checkpoint_dir``: enables periodic whole-table snapshots
    (storage.checkpoint.VectorCheckpointer) every ``checkpoint_period``
    seconds, keeping ``checkpoint_keep`` — the whole-silo resume path. If
    a checkpoint exists at start, the silo restores it before serving.
    """
    for cls in grain_classes:
        if not issubclass(cls, VectorGrain):
            raise TypeError(f"{cls.__name__} is not a VectorGrain")
    if mesh is not None:
        refuse_on_group(mesh, "add_vector_grains (hosting)")

    def install(silo) -> None:
        import asyncio

        if silo.vector is None:
            silo.vector = VectorRuntime(
                mesh=mesh, capacity_per_shard=capacity_per_shard,
                options=options)
        # off-loop tick pipeline: silo-hosted runtimes take the lever
        # from SiloConfig (the A/B switch; DispatchOptions.offloop_tick
        # only governs standalone engines)
        silo.vector.offloop_tick = silo.config.offloop_tick
        if silo.tracer is not None:
            silo.vector.tracer = silo.tracer  # device ticks join the traces
        if silo.ingest_stats is not None:
            # device-half ingest attribution (staging/transfer/tick land
            # in the silo's registry beside the host-side stages)
            silo.vector.stats = silo.ingest_stats
        if silo.shed_trend is not None:
            # device-tier queue-wait feeds the same load-shed trend the
            # host turns feed (vector-heavy overload sheds too)
            silo.vector.shed_trend = silo.shed_trend
        if silo.ledger is not None:
            # cost attribution: batch epilogues charge the silo's ledger
            # and the tables grow the on-device per-slot cost twin
            silo.vector.ledger = silo.ledger
            silo.vector.enable_cost_tracking()
        silo.vector.register(*grain_classes)
        for cls in grain_classes:
            silo.vector_interfaces[cls.__name__] = cls
        for cls, n in (dense or {}).items():
            silo.vector.table(cls).ensure_dense(n)
        _install_ownership_sweep(silo)
        if checkpoint_dir is not None:
            _install_checkpoints(silo)
        if storage is None:
            return

        from ..storage.checkpoint import VectorStorageBridge

        silo.vector.enable_dirty_tracking()
        if not hasattr(silo, "vector_bridges"):
            silo.vector_bridges = {}
        for cls in grain_classes:
            silo.vector_bridges[cls] = VectorStorageBridge(
                silo.vector, cls, storage)
        _install_flusher(silo)

    def _install_ownership_sweep(silo) -> None:
        """Membership-change sweep: a silo that loses a key's ring
        ownership must release its resident row — keeping it would serve
        a STALE copy if ownership ever returns (the interim owner wrote
        and persisted newer state), forking the key. Releasing forces
        recovery-on-first-touch, the same rebuild path a fresh owner
        takes. Host-tier analog: duplicate-activation deactivation on
        directory re-registration. Rows with acked-but-unflushed writes
        are flushed FIRST (leave-side handoff: make the tail durable
        before handing the key over) when a write-behind bridge exists.
        A key the ring gives one of this silo's own worker processes
        (``runtime.multiproc``) stays: their vector calls run on this
        engine, the one device engine of the silo's processes."""
        import asyncio
        import logging

        # strong refs: the loop holds tasks weakly, and a GC'd sweep
        # would silently skip the release this mechanism exists for
        sweep_tasks: set = set()

        def on_view_change(alive, dead) -> None:
            async def sweep() -> None:
                await asyncio.sleep(0)  # after the locator applies the view
                me = silo.silo_address
                ring = silo.locator.ring
                workers = silo.workers.silo_addresses() \
                    if silo.workers is not None else ()

                def owned(uh: int) -> bool:
                    o = ring.owner(uh)
                    return o is None or o == me or o in workers

                n = 0
                for cls in grain_classes:
                    tbl = silo.vector.tables.get(cls)
                    if tbl is None or not tbl.key_to_slot:
                        continue
                    gone = tbl.unowned_keys(owned)
                    if not gone:
                        continue
                    bridge = getattr(silo, "vector_bridges", {}).get(cls)
                    if bridge is not None:
                        try:
                            await bridge.flush(gone)
                        except Exception:  # noqa: BLE001 — handoff flush
                            # is best-effort; a conflict means the new
                            # owner already persisted newer state
                            logging.getLogger("orleans.vector").info(
                                "handoff flush failed for %s",
                                cls.__name__, exc_info=True)
                    for kh in gone:
                        tbl.release(kh)
                    n += len(gone)
                if n:
                    silo.stats.increment("vector.ownership.released", n)
                    logging.getLogger("orleans.vector").info(
                        "released %d device-tier rows after ownership "
                        "re-range", n)

            t = asyncio.get_running_loop().create_task(sweep())
            sweep_tasks.add(t)
            t.add_done_callback(sweep_tasks.discard)

        def start() -> None:
            if silo.membership is not None:
                silo.membership.subscribe(on_view_change)

        from ..runtime.silo import ServiceLifecycleStage

        silo.subscribe_lifecycle(
            ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES, start, None)

    def _install_flusher(silo) -> None:
        import asyncio

        state = {"task": None}

        async def flush_all(strict: bool = False) -> int:
            n = 0
            first_error: BaseException | None = None
            for cls in grain_classes:
                keys = silo.vector.drain_dirty(cls)
                if not len(keys):
                    continue
                try:
                    n += await silo.vector_bridges[cls].flush(
                        keys, strict=strict)
                except asyncio.CancelledError:
                    # cancelled mid-flush: the keys are already drained —
                    # re-mark them so the final stop() drain retries
                    # instead of losing them
                    silo.vector._mark_dirty(cls, keys)
                    raise
                except BaseException as e:  # noqa: BLE001
                    # batch-phase failure (e.g. the device→host gather) or
                    # a strict re-raise: re-mark so nothing drained is
                    # lost (per-key write failures were already re-marked
                    # inside flush; re-marking them twice is harmless),
                    # then KEEP GOING — one class's bad storage must not
                    # abandon the other classes' shutdown drain
                    silo.vector._mark_dirty(cls, keys)
                    first_error = first_error or e
            if n:
                silo.stats.increment("vector.storage.flushed", n)
            if first_error is not None:
                raise first_error
            return n

        async def flusher() -> None:
            # cooperative shutdown, as the checkpoint snapshotter's: a
            # flush yields to the loop between slices, so a cancel would
            # land mid-flush and the final drain would write its rows
            # again; stop() sets `quit` and awaits the flush in flight
            while True:
                try:
                    await asyncio.wait_for(state["quit"].wait(),
                                           timeout=flush_period)
                    return  # graceful stop requested
                except asyncio.TimeoutError:
                    pass
                if silo.status in ("Dead", "Stopped"):
                    return  # kill skips lifecycle stops; die with the silo
                try:
                    await flush_all()
                except Exception:  # noqa: BLE001 — keep flushing next period
                    import logging
                    logging.getLogger("orleans.vector").exception(
                        "write-behind flush failed")

        def start() -> None:
            state["quit"] = asyncio.Event()
            state["task"] = asyncio.get_running_loop().create_task(flusher())

        async def stop() -> None:
            task, state["task"] = state["task"], None
            if task is not None:
                state["quit"].set()
                # the flush in flight completes (or re-marks what it
                # drained on failure) BEFORE the final drain below
                await asyncio.gather(task, return_exceptions=True)
            # final write-behind drain: strict — a failure here has no
            # next period to retry, so it must surface out of stop()
            await flush_all(strict=True)

        from ..runtime.silo import ServiceLifecycleStage

        silo.subscribe_lifecycle(
            ServiceLifecycleStage.APPLICATION_SERVICES, start, stop)

    def _install_checkpoints(silo) -> None:
        import asyncio

        from ..runtime.silo import ServiceLifecycleStage
        from ..storage.checkpoint import VectorCheckpointer

        ckpt = VectorCheckpointer(silo.vector, checkpoint_dir,
                                  max_to_keep=checkpoint_keep)
        silo.vector_checkpointer = ckpt
        state = {"task": None, "step": 0, "quit": None}

        async def snapshotter() -> None:
            # cooperative shutdown (never cancelled): a write must never
            # overlap the final stop() save — stop sets `quit` and AWAITS
            # this task, which finishes any in-flight write before exiting
            while True:
                try:
                    await asyncio.wait_for(state["quit"].wait(),
                                           timeout=checkpoint_period)
                    return  # graceful stop requested
                except asyncio.TimeoutError:
                    pass
                if silo.status in ("Dead", "Stopped", "ShuttingDown"):
                    return  # killed silos must not overwrite the successor's
                            # checkpoints (kill skips lifecycle stops)
                try:
                    # capture on the loop (under the tick fence), write in
                    # a thread — a multi-GB table write must not stall
                    # membership probes and gateway traffic
                    state["step"] += 1
                    captured = ckpt.capture()
                    await asyncio.to_thread(ckpt.write, state["step"],
                                            captured)
                    silo.stats.increment("vector.checkpoints")
                except Exception:  # noqa: BLE001 — next period retries
                    import logging
                    logging.getLogger("orleans.vector").exception(
                        "table checkpoint failed")

        def start() -> None:
            state["quit"] = asyncio.Event()
            latest = ckpt.latest_step()
            if latest is not None:
                ckpt.restore(latest)  # whole-silo resume before serving
                state["step"] = latest
            state["task"] = asyncio.get_running_loop().create_task(
                snapshotter())

        async def stop() -> None:
            task, state["task"] = state["task"], None
            if task is not None:
                state["quit"].set()
                await task  # in-flight write completes before the final save
            state["step"] += 1
            ckpt.save(state["step"])  # final snapshot

        silo.subscribe_lifecycle(
            ServiceLifecycleStage.APPLICATION_SERVICES, start, stop)

    return builder.configure(install)
