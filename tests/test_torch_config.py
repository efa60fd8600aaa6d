"""Parity of the port's typed options groups (orleans_tpu_torch.config)
with orleans_tpu.config, on the CPU.

The cases of tests/test_config.py run against both packages with the same
inputs: every validator rejects what the reference's rejects, with the
same message, and ``flatten``/``apply_options``/``with_options`` give the
same flat ``SiloConfig``, field for field. Tolerance: exact (the values are
the inputs). The port differs on purpose in one place, tested here:
``DispatchOptions`` has no ``exchange_capacity``. ``batched_egress``
defaults to on in both packages (the egress batcher is ported), and the
groups of the multi-process and multi-loop silos, metrics, SLO, ledger and
OTLP export build as the reference's do (their modules are ported).
"""

import dataclasses
import logging
from types import SimpleNamespace

import pytest

import orleans_tpu.config as jc
import orleans_tpu.core.errors as je
import orleans_tpu.runtime as jr
import orleans_tpu.runtime.silo as jsilo
import orleans_tpu_torch.config as tc
import orleans_tpu_torch.core.errors as te
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.runtime.silo as tsilo

J = SimpleNamespace(name="jax", c=jc, err=je.ConfigurationError, rt=jr,
                    silo=jsilo)
T = SimpleNamespace(name="torch", c=tc, err=te.ConfigurationError, rt=tr,
                    silo=tsilo)
PKGS = pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])

# SiloConfig fields whose defaults differ on purpose (none since the
# egress batcher is ported)
DIVERGENT: set = set()


def _flat(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in DIVERGENT}


def _both(fn):
    """``fn(pkg)`` for the JAX package, then the port: the pair."""
    return fn(J), fn(T)


def _raises(pkg, fn) -> str:
    with pytest.raises(pkg.err) as e:
        fn(pkg)
    return str(e.value)


# ---------------------------------------------------------------------------
# validators
# ---------------------------------------------------------------------------

@PKGS
def test_defaults_all_valid(pkg):
    c = pkg.c
    c.validate_options(c.ClusterOptions(), c.MessagingOptions(),
                       c.SchedulingOptions(), c.GrainCollectionOptions(),
                       c.MembershipOptions(), c.DirectoryOptions(),
                       c.LoadSheddingOptions(), c.RebalanceOptions(),
                       c.TracingOptions(), c.MetricsOptions(),
                       c.ProfilingOptions(), c.SloOptions(),
                       c.StreamOptions(), c.LedgerOptions(),
                       c.DispatchOptions())


BAD = [
    ("MessagingOptions", {"response_timeout": 0}),
    ("MessagingOptions", {"ingress_loops": 65}),
    ("MessagingOptions", {"egress_shards": -1}),
    ("MessagingOptions", {"worker_procs": 2, "ingress_loops": 2}),
    ("DirectoryOptions", {"cache_size": -1}),
    ("DirectoryOptions", {"cache_initial_ttl": 200.0}),
    ("DirectoryOptions", {"cache_refresh_period": -1.0}),
    ("GrainCollectionOptions", {"collection_age": 10,
                                "collection_quantum": 60}),
    ("MembershipOptions", {"votes_needed": 5, "num_probed": 2}),
    ("MembershipOptions", {"num_probed": 0}),
    ("ClusterOptions", {"cluster_id": ""}),
    ("LoadSheddingOptions", {"queue_wait_limit": -1.0}),
    ("RebalanceOptions", {"imbalance_ratio": 0.5}),
    ("TracingOptions", {"sample_rate": 1.5}),
    ("TracingOptions", {"tail_slow_percentile": 1.0}),
    ("MetricsOptions", {"port": 70000}),
    ("ProfilingOptions", {"top_k": 0}),
    ("SloOptions", {"fast_window": 300.0}),
    ("SloOptions", {"latency_target": 1.0}),
    ("StreamOptions", {"device_cache_capacity": 0}),
    ("LedgerOptions", {"tenant_of": "not callable"}),
    ("DispatchOptions", {"capacity_per_shard": 0}),
]


@pytest.mark.parametrize("group,kw", BAD,
                         ids=[f"{g}-{'-'.join(kw)}" for g, kw in BAD])
def test_validators_reject_alike(group, kw):
    """Every bad value is refused by both packages, with one message."""
    j, t = _both(lambda pkg: _raises(
        pkg, lambda p: getattr(p.c, group)(**kw).validate()))
    assert j == t


def test_port_configuration_error_is_one_class():
    """config's error is core.errors' (a ValueError too, as the port's
    DispatchOptions raised one before the groups came)."""
    assert tc.ConfigurationError is te.ConfigurationError
    assert issubclass(te.ConfigurationError, ValueError)


# ---------------------------------------------------------------------------
# flatten / apply_options
# ---------------------------------------------------------------------------

def test_flatten_overlays_groups():
    j, t = _both(lambda pkg: pkg.c.flatten(
        pkg.c.MessagingOptions(response_timeout=7.5),
        pkg.c.MembershipOptions(probe_period=0.25), name="s1"))
    assert _flat(j) == _flat(t)
    assert t.name == "s1" and t.response_timeout == 7.5
    assert t.membership_probe_period == 0.25
    assert t.collection_quantum == 60.0  # untouched groups keep defaults


def test_flatten_every_group_alike():
    """Every group with non-default values flattens to the same fields."""
    def groups(c):
        return (c.ClusterOptions("c", "s"),
                c.MessagingOptions(response_timeout=4.0,
                                   max_enqueued_requests=7,
                                   batched_ingress=False, offloop_tick=False),
                c.SchedulingOptions(turn_warning_length=0.5,
                                    detect_deadlocks=True),
                c.GrainCollectionOptions(collection_age=300.0),
                c.MembershipOptions(probe_period=0.5, votes_needed=3),
                c.DirectoryOptions(cache_size=9, cache_refresh_period=0.0),
                c.LoadSheddingOptions(enabled=True, limit=5),
                c.RebalanceOptions(period=1.0, budget=3),
                c.TracingOptions(enabled=True, sample_rate=0.5),
                c.MetricsOptions(sample_period=2.0),
                c.ProfilingOptions(enabled=True, ring=10),
                c.SloOptions(period=2.0),
                c.StreamOptions(device_fanout=True,
                                device_cache_capacity=64),
                c.LedgerOptions(top_k=8))
    j, t = _both(lambda pkg: pkg.c.flatten(*groups(pkg.c)))
    assert _flat(j) == _flat(t)
    assert t.stream_device_fanout is True
    assert t.stream_device_cache_capacity == 64
    assert t.directory_cache_refresh_period == 0.0


def test_flatten_validates():
    j, t = _both(lambda pkg: _raises(
        pkg, lambda p: p.c.flatten(p.c.MessagingOptions(response_timeout=-1))))
    assert j == t


def test_apply_options_on_existing_config():
    def run(pkg):
        cfg = pkg.silo.SiloConfig(name="x")
        out = pkg.c.apply_options(cfg, pkg.c.SchedulingOptions(
            detect_deadlocks=True, turn_warning_length=0.5))
        assert out is cfg
        return cfg
    j, t = _both(run)
    assert _flat(j) == _flat(t) and t.detect_deadlocks is True


def test_flat_map_names_port_fields_only():
    """Every flat field of the reference's map exists on the port's
    SiloConfig, so no group field is dropped; a field that did not would
    be refused, not added."""
    assert set(jc._FLAT_MAP) == set(tc._FLAT_MAP)
    port_fields = {f.name for f in dataclasses.fields(tsilo.SiloConfig)}
    assert set(tc._FLAT_MAP) <= port_fields

    class Partial:  # a flat config without the messaging fields
        pass

    with pytest.raises(te.ConfigurationError, match="response_timeout"):
        tc.apply_options(Partial(), tc.MessagingOptions())


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

def test_with_options():
    j, t = _both(lambda pkg: pkg.rt.SiloBuilder().with_name("opt-silo")
                 .with_options(pkg.c.MessagingOptions(response_timeout=3.0),
                               pkg.c.GrainCollectionOptions(
                                   collection_age=120,
                                   collection_quantum=30)).config)
    assert _flat(j) == _flat(t)
    assert t.response_timeout == 3.0 and t.collection_age == 120


@PKGS
def test_with_options_rejects_invalid(pkg):
    with pytest.raises(pkg.err):
        pkg.rt.SiloBuilder().with_options(pkg.c.MembershipOptions(
            num_probed=0))


def test_cluster_identity_flows_to_config():
    j, t = _both(lambda pkg: pkg.rt.SiloBuilder().with_options(
        pkg.c.ClusterOptions(cluster_id="prod", service_id="svc1")).config)
    assert (t.cluster_id, t.service_id) == ("prod", "svc1")
    assert _flat(j) == _flat(t)


def test_unconsumed_group_rejected_not_dropped():
    j, t = _both(lambda pkg: _raises(
        pkg, lambda p: p.rt.SiloBuilder().with_options(
            p.c.DispatchOptions(capacity_per_shard=4))))
    assert j == t and "VectorRuntime" in t


def test_dispatch_options_consumed_by_vector_runtime():
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.parallel import make_mesh
    rt = VectorRuntime(mesh=make_mesh(1, device="cpu"),
                       options=tc.DispatchOptions(capacity_per_shard=64))
    assert rt.capacity_per_shard == 64
    # the port's group is the reference's without exchange_capacity
    assert {f.name for f in dataclasses.fields(jc.DispatchOptions)} - \
        {f.name for f in dataclasses.fields(tc.DispatchOptions)} == \
        {"exchange_capacity"}


def test_messaging_batched_egress_defaults_off_in_port():
    """(Named for the divergence it used to hold.) The port's default is
    now the reference's, on, in the options group and the flat config
    alike, and a silo builds with it and with it off."""
    assert jc.MessagingOptions().batched_egress is True
    assert tc.MessagingOptions().batched_egress is True
    cfg = tr.SiloBuilder().with_options(tc.MessagingOptions(
        response_timeout=2.0)).config
    assert cfg.batched_egress is True
    assert tr.SiloBuilder().with_options(
        tc.MessagingOptions()).build().message_center.egress is not None
    assert tr.SiloBuilder().with_options(tc.MessagingOptions(
        batched_egress=False)).build().message_center.egress is None


# the groups of ROADMAP Queue 1 items 16-17, refused at build() until
# their modules were ported; the ids are the refusal tests' ids
UNPORTED = [
    (tc.MessagingOptions, {"worker_procs": 2}, "multiproc"),
    (tc.MessagingOptions, {"ingress_loops": 2}, "multiloop"),
    (tc.MessagingOptions, {"egress_shards": 1}, "multiloop"),
    (tc.MetricsOptions, {"enabled": True}, "metrics"),
    (tc.MetricsOptions, {"port": 0}, "metrics"),
    (tc.SloOptions, {"enabled": True}, "slo"),
    (tc.LedgerOptions, {"enabled": True}, "ledger"),
    (tc.TracingOptions, {"otlp_endpoint": "http://localhost:4318"},
     "export"),
]


@pytest.mark.parametrize("group,kw,module", UNPORTED,
                         ids=[f"{g.__name__}-{'-'.join(kw)}"
                              for g, kw, _ in UNPORTED])
def test_unported_groups_are_refused_at_build(group, kw, module):
    """Each group now builds as the JAX package's does: the same flat
    ``SiloConfig`` (no refusal), or for ``worker_procs`` on the in-process
    fabric the same ``ConfigurationError`` (SO_REUSEPORT needs a
    ``SocketFabric``)."""
    def outcome(pkg):
        b = pkg.rt.SiloBuilder().with_options(
            getattr(pkg.c, group.__name__)(**kw))
        try:
            return "built", _flat(b.build().config)
        except pkg.err as e:
            return "refused", str(e)
    j, t = _both(outcome)
    assert t == j
    assert t[0] == ("refused" if module == "multiproc" else "built")


def test_log_options_dumps_every_field(caplog):
    def run(pkg):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="orleans.options"):
            pkg.c.log_options(pkg.c.MessagingOptions(),
                              pkg.c.MembershipOptions())
        return [r.getMessage() for r in caplog.records]
    j, t = _both(run)
    assert "MessagingOptions.response_timeout = 30.0" in t
    assert "MembershipOptions.votes_needed = 2" in t
    assert j == t
