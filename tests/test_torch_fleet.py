"""The port's fleet (``raft_stereo_tpu_torch/serving/fleet/``) against the
JAX package's, on the CPU, over stdlib stub replicas.

Three kinds of test:

* the JAX package's own fleet tests (``tests/test_fleet.py``) re-bound to
  the port (``torch_fleet_support.port_twin``): the same scenario and the
  same assertions, the port's code;
* the same scripted scenario driven through JAX's router and through the
  port's (``torch_fleet_support.drive``), each over a fresh fleet of the
  same stubs, and everything a client or an operator sees compared with
  ``==``: statuses, typed bodies, ``X-*`` headers, what each stub was
  asked, counters, the lost-session ledger, ``/fleet``, ``/metrics`` and
  ``/metrics/fleet`` (trace ids, clocks, ports and jittered retry hints
  normalized away);
* direct comparisons: ring assignments over 10,000 seeded keys, HA
  ledger directories replayed across packages both ways, rollout
  assignments and demotions, and the autoscaler's decisions on a
  scripted pressure trace.

No model runs here; ``tests/test_torch_fleet_replicas.py`` puts the
port's router in front of the port's serving engine.
"""

import os
import sys

import numpy as np
import pytest

from raft_stereo_tpu.serving import fleet as jfleet
from raft_stereo_tpu.serving.fleet import autoscaler as jautoscaler
from raft_stereo_tpu.serving.fleet import rollout as jrollout
from raft_stereo_tpu_torch.serving import fleet as pfleet
from raft_stereo_tpu_torch.serving.fleet import autoscaler as pautoscaler
from raft_stereo_tpu_torch.serving.fleet import rollout as prollout
from test_fleet import FakeClock, RecordingLauncher, StubReplica
from torch_fleet_support import (BASE, JAX, PORT, drive,  # noqa: F401
                                 fleet3, port_twin, root_spans, scrub,
                                 span_tree)



# ------------------------------------------------- JAX's tests, on the port
NOARG_TESTS = [
    "test_ring_sticky_and_deterministic",
    "test_ring_removal_remaps_only_the_dead_members_keys",
    "test_ring_readd_restores_original_assignment",
    "test_ring_empty_and_single",
    "test_router_brownout_propagates_fleet_wide",
    "test_lost_ledger_bounded_by_cap_and_gauge",
    "test_xl_routing_heterogeneous_fleet",
    "test_autoscaler_hysteresis_on_scripted_trace",
    "test_autoscaler_respects_bounds_and_cooldown",
]
FLEET3_TESTS = [
    "test_router_stateless_balances_and_counts",
    "test_router_stateless_failover_zero_loss",
    "test_router_sessions_sticky_then_lost_typed_then_reseed",
    "test_router_remap_fraction_on_death_is_about_one_nth",
    "test_router_health_blackhole_counts_as_dead",
    "test_router_not_ready_replica_out_of_rotation",
    "test_router_all_dead_typed_no_replicas",
    "test_drain_handoff_remaps_sessions_zero_410",
    "test_drain_503_race_rerouted_inline",
    "test_drain_without_manifest_falls_back_to_typed_loss",
    "test_xl_unavailable_typed_over_http",
    "test_router_http_surface_and_passthrough",
]
TMP_TESTS = [
    "test_ledger_fencing_rejects_stale_writer",
    "test_ledger_replay_skips_torn_tail",
    "test_ledger_lease_staleness",
    "test_ha_takeover_never_double_fires_a_loss",
    "test_ha_standby_serves_while_passive",
]


@pytest.mark.parametrize("name", NOARG_TESTS)
def test_fleet_counterpart(name):
    port_twin("test_fleet", name)()


@pytest.mark.parametrize("name", FLEET3_TESTS)
def test_fleet_counterpart_on_three_stubs(name, fleet3):
    port_twin("test_fleet", name)(fleet3)


@pytest.mark.parametrize("name", TMP_TESTS)
def test_fleet_counterpart_on_a_ledger_dir(name, tmp_path):
    port_twin("test_fleet", name)(tmp_path)


# ---------------------------------------------------------------- the ring
@pytest.mark.parametrize("members", [3, 4, 5])
def test_ring_assignments_equal_to_jax(members):
    """10,000 seeded keys over 3-5 members: the port's owners equal JAX's,
    after a member's removal (only its keys move, to the same owners) and
    after its re-add (the first assignment comes back)."""
    rng = np.random.default_rng(members)
    keys = [f"sess-{rng.integers(1 << 62):x}" for _ in range(10_000)]
    names = [f"replica-{i}" for i in range(members)]
    j, p = jfleet.HashRing(names), pfleet.HashRing(names[::-1])
    first = j.assignment(keys)
    assert p.assignment(keys) == first
    assert set(first.values()) == set(names)
    gone = names[members // 2]
    j.remove(gone)
    p.remove(gone)
    after = j.assignment(keys)
    assert p.assignment(keys) == after
    assert all(after[k] == v for k, v in first.items() if v != gone)
    j.add(gone)
    p.add(gone)
    assert p.assignment(keys) == j.assignment(keys) == first
    assert p.members == j.members


# ------------------------------------------------ scenarios, both routers
def scenario(stubs=(("s0", {}), ("s1", {}), ("s2", {})), **cfg):
    """Declare a scenario's stubs (name, StubReplica keywords) and its
    ``RouterConfig`` (``BASE`` updated; a callable value gets the
    scenario's scratch directory)."""
    def wrap(fn):
        fn.stubs = stubs
        fn.config = lambda tmp: dict(BASE, **{
            k: (v(tmp) if callable(v) else v) for k, v in cfg.items()})
        return fn
    return wrap


def _owner(stubs, sid):
    return next(s for s in stubs if sid in s.sessions)


@scenario()
def stateless_balance_and_failover(rec, fleet, clock):
    for i in range(9):
        rec.http("/v1/disparity?format=npy", f"req{i}".encode(),
                 headers={"Content-Type": "application/x-npz"})
    rec.stubs[0].kill()          # dead, still in rotation: fails over
    for i in range(12):
        rec.http("/v1/disparity", f"after{i}".encode())
    rec.snapshot()


@scenario()
def sessions_sticky_loss_reseed(rec, fleet, clock):
    sids = [f"cam-{i}" for i in range(12)]
    for k in range(2):
        for sid in sids:
            rec.http(f"/v1/stream/{sid}", f"f{k}".encode())
    rec.snapshot()
    _owner(rec.stubs, sids[0]).kill()
    for sid in sids:             # the first by transport, the rest owed
        rec.http(f"/v1/stream/{sid}", b"g")
    for sid in sids:             # fired once: each reseeds
        rec.http(f"/v1/stream/{sid}", b"h")
    rec.http("/v1/stream/cam-3", method="DELETE")
    rec.http("/v1/stream", b"x")  # no id: the router's typed 400
    rec.snapshot()


@scenario()
def remap_blackhole_not_ready_all_dead(rec, fleet, clock):
    for i in range(30):
        rec.http(f"/v1/stream/cam-{i}", b"f")
    rec.stubs[2].blackhole_health = True
    rec.router.check_replicas()
    rec.snapshot()
    rec.stubs[2].blackhole_health = False
    rec.router.check_replicas()
    rec.stubs[1].ready = False
    rec.router.check_replicas()
    for i in range(6):
        rec.http("/v1/disparity", f"x{i}".encode())
    rec.stubs[1].ready = True
    rec.router.check_replicas()
    rec.stubs[0].kill()
    rec.router.check_replicas()
    rec.snapshot()
    for s in rec.stubs[1:]:
        s.kill()
    rec.router.check_replicas()
    rec.router.check_replicas()
    rec.http("/v1/disparity", b"x")
    rec.http("/v1/stream/cam-29", b"f")
    rec.http("/readyz")
    rec.http("/healthz")
    rec.snapshot()


@scenario(stubs=tuple((f"s{i}", {"queue_depth": 60, "queue_limit": 64})
                      for i in range(3)),
          fleet_brownout=True, brownout_engage_s=0.5,
          brownout_restore_s=1.0, brownout_max_level=2)
def fleet_brownout(rec, fleet, clock):
    for step in range(3):
        rec.router.check_replicas()
        rec.note(f"level {step}", rec.router.brownout_level)
        clock.t += 0.6
    for s in rec.stubs:
        s.queue_depth = 0
    for step in range(4):
        rec.router.check_replicas()
        rec.note(f"calm {step}", rec.router.brownout_level)
        clock.t += 1.1
    rec.snapshot()


def _route(rec, n):
    owner = {}
    for i in range(n):
        sid = f"cam-{i}"
        rec.http(f"/v1/stream/{sid}", b"f")
        owner[sid] = _owner(rec.stubs, sid)
    victim = next(s for s in rec.stubs if s in owner.values())
    return owner, victim, [sid for sid, o in owner.items() if o is victim]


@scenario()
def drain_handoff(rec, fleet, clock):
    owner, victim, moved = _route(rec, 12)
    victim.draining = True
    victim.handoff_manifest = {"artifact": "abc123", "sessions": moved,
                               "count": len(moved)}
    rec.router.check_replicas()
    rec.snapshot()
    for sid in list(owner) + moved[:2]:
        rec.http(f"/v1/stream/{sid}", b"next")
    rec.snapshot()


@scenario()
def drain_503_race(rec, fleet, clock):
    owner, victim, moved = _route(rec, 8)
    victim.draining = True       # no probe pass: the router routes there
    victim.handoff_manifest = {"artifact": "race-key", "sessions": moved,
                               "count": len(moved)}
    for sid in moved:
        rec.http(f"/v1/stream/{sid}", b"race")
    rec.snapshot()


@scenario()
def drain_without_manifest(rec, fleet, clock):
    owner, victim, moved = _route(rec, 8)
    victim.draining = True       # the manifest stays 404
    rec.router.check_replicas()
    rec.snapshot()
    victim.kill()
    rec.router.check_replicas()
    rec.router.check_replicas()
    for sid in moved:
        rec.http(f"/v1/stream/{sid}", b"after")
        rec.http(f"/v1/stream/{sid}", b"reseed")
    rec.snapshot()


@scenario(stubs=(("s0", {}), ("s1", {})), session_lost_cap=5)
def lost_ledger_cap(rec, fleet, clock):
    owner, _, _ = _route(rec, 20)
    victim = max(rec.stubs, key=lambda s: sum(o is s
                                              for o in owner.values()))
    victim.kill()
    rec.router.check_replicas()
    rec.snapshot()
    for sid in owner:
        rec.http(f"/v1/stream/{sid}", b"after")
    rec.snapshot()


XL = {"mesh": "rows=4", "label": "rows4", "groups": 1,
      "devices_per_group": 4, "threshold_pixels": 2_000_000,
      "batch_sizes": [1]}


@scenario(stubs=(("plain0", {}), ("plain1", {}), ("big0", {"xl": XL})))
def xl_routing(rec, fleet, clock):
    for i in range(4):
        rec.http("/v1/disparity?tier=xl", f"big{i}".encode())
    rec.http("/v1/disparity", b"big", headers={"X-Tier": "xl"})
    for i in range(6):
        rec.http("/v1/disparity", f"x{i}".encode())
    rec.stubs[2].kill()
    rec.router.check_replicas()
    rec.http("/v1/disparity?tier=xl", b"big")
    rec.http("/v1/disparity", b"x")
    rec.snapshot()


@scenario(trace_sample_rate=1.0, slo_ms=10_000.0)
def traced(rec, fleet, clock):
    from raft_stereo_tpu_torch.telemetry.spans import decode_traceparent
    tracer = rec.router.tracer

    def tree(hdrs):
        spans = root_spans(tracer, hdrs["X-Trace-Id"])
        rec.note("tree", span_tree(spans))
        return spans

    _, hdrs, _ = rec.http("/v1/disparity", b"px")
    spans = tree(hdrs)
    fwd = next(s for s in spans if s["name"] == "route.forward")
    handler = next(s for s in rec.stubs if s.stateless_headers)
    ctx = decode_traceparent(handler.stateless_headers[-1]["traceparent"])
    rec.note("traceparent names the forward span",
             (ctx.trace_id, ctx.parent_span_id)
             == (hdrs["X-Trace-Id"], fwd["span_id"]))
    # the replica's half of the trace, merged by the federated view
    handler.spans[ctx.trace_id] = [{
        "name": "serve.request", "trace_id": ctx.trace_id,
        "span_id": "aa" * 4, "parent_id": ctx.parent_span_id,
        "start_us": 1.0, "duration_us": 42.0, "attrs": {}}]
    rec.http(f"/debug/spans?trace={ctx.trace_id}")
    _, hdrs, _ = rec.http("/v1/stream/cam-x", b"f")
    tree(hdrs)
    # a failover inside one trace: two forward children under one root
    rec.stubs[0].kill()
    for i in range(6):
        _, hdrs, _ = rec.http("/v1/disparity", f"px{i}".encode())
        tree(hdrs)
    _owner(rec.stubs, "cam-x").kill()
    rec.router.check_replicas()
    rec.router.check_replicas()
    _, hdrs, _ = rec.http("/v1/stream/cam-x", b"f")
    tree(hdrs)
    rec.note("burns", rec.router.slo_tick())
    rec.snapshot()


@scenario(trace_sample_rate=1.0, slo_ms=10_000.0)
def federation(rec, fleet, clock):
    for i in range(6):
        rec.http("/v1/disparity", f"f{i}".encode())
    rec.stubs[0].metrics_text += (
        '# HELP serve_requests_admitted_total Admitted.\n'
        '# TYPE serve_requests_admitted_total counter\n'
        'serve_requests_admitted_total{tier="quality"} 3\n')
    rec.snapshot(federate=True)
    rec.stubs[1].kill()
    rec.snapshot(federate=True)


@scenario(trace_sample_rate=1.0,
          flight_recorder_dir=lambda tmp: str(tmp / "flightrecorder"))
def watchdog_dump(rec, fleet, clock):
    rec.note("quiet", rec.router.slo_watchdog.check({"5m": 1.0,
                                                      "1h": 1.0}))
    rec.note("dump", rec.router.slo_watchdog.check({"5m": 100.0,
                                                     "1h": 100.0}))
    rec.note("latched", rec.router.slo_watchdog.check({"5m": 100.0,
                                                        "1h": 100.0}))
    rec.snapshot()


SCENARIOS = [stateless_balance_and_failover, sessions_sticky_loss_reseed,
             remap_blackhole_not_ready_all_dead, fleet_brownout,
             drain_handoff, drain_503_race, drain_without_manifest,
             lost_ledger_cap, xl_routing, traced, federation,
             watchdog_dump]


@pytest.mark.parametrize("scene", SCENARIOS, ids=lambda f: f.__name__)
def test_router_scenario_equal_to_jax(scene, tmp_path):
    """One scripted scenario through JAX's router and through the port's:
    every record equal (first difference reported by its tag)."""
    want = drive(JAX, scene, StubReplica, FakeClock, tmp_path / "jax")
    got = drive(PORT, scene, StubReplica, FakeClock, tmp_path / "port")
    assert [t for t, _ in got] == [t for t, _ in want]
    for (tag, g), (_, w) in zip(got, want):
        assert g == w, tag


# -------------------------------------------------- ledger dirs, both ways
def _ha_primary(fleet, stubs, ha):
    """A primary that writes every record kind: sessions routed, one
    replica dead (lost), one 410 fired, one replica drained with a
    manifest (handoff)."""
    router = fleet.FleetRouter(
        {s.name: s.url for s in stubs},
        fleet.RouterConfig(ha_dir=ha, router_name="rt-a", **BASE))
    router.check_replicas()
    owner = {}
    for i in range(16):
        sid = f"cam-{i}"
        router.forward_session(sid, "POST", f"/v1/stream/{sid}", b"f", [])
        owner[sid] = _owner(stubs, sid).name
    dead, drained = stubs[0], stubs[1]
    lost = [sid for sid, o in owner.items() if o == dead.name]
    moved = [sid for sid, o in owner.items() if o == drained.name]
    dead.kill()
    router.check_replicas()
    with pytest.raises(fleet.SessionLost):
        router.forward_session(lost[0], "POST", f"/v1/stream/{lost[0]}",
                               b"f", [])
    drained.draining = True
    drained.handoff_manifest = {"artifact": "k-" + "ab" * 8,
                                "sessions": moved, "count": len(moved)}
    router.check_replicas()
    router.stop()
    return lost, moved


def _ha_takeover(fleet, stubs, ha, lost, moved):
    """The standby's state after takeover, and what it answers."""
    standby = fleet.FleetRouter(
        {s.name: s.url for s in stubs},
        fleet.RouterConfig(ha_dir=ha, router_name="rt-b", standby=True,
                           **BASE))
    try:
        assert standby.fleet_status()["role"] == "standby"
        standby.check_replicas()
        epoch = standby.takeover()
        state = {"epoch": epoch, "role": standby.fleet_status()["role"],
                 "lost": sorted(standby._lost.items()),
                 "handoff": sorted((sid, key) for sid, (key, _t)
                                   in standby._handoff.items())}
        state["lost"] = [(sid, rep) for sid, (rep, _t) in state["lost"]]
        answers = []
        for sid in lost[:3]:          # fired stays fired; owed fires once
            for _ in range(2):
                try:
                    st, _, _ = standby.forward_session(
                        sid, "POST", f"/v1/stream/{sid}", b"f", [])
                except fleet.SessionLost:
                    st = 410
                answers.append((sid, st))
        st, _, _ = standby.forward_session(
            moved[0], "POST", f"/v1/stream/{moved[0]}", b"f", [])
        tags = [h.get("X-Handoff-Artifact") for s in stubs
                for sid, h in s.stream_headers if sid == moved[0]]
        state.update(answers=answers, adopted=(st, tags[-1]))
        return state
    finally:
        standby.stop()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-writes-port-replays",
                              "port-writes-jax-replays"])
def test_ledger_dir_replayed_across_packages(writer, reader, tmp_path):
    """A ledger directory one package's primary wrote is taken over by
    the other package's standby, and by a standby of the writer's own
    package on a copy of it: the same owed losses, handoffs, epoch and
    answers (a fired 410 never fires again, an owed one fires once, a
    handed-off session carries its artifact)."""
    import shutil
    mods = {JAX: jfleet, PORT: pfleet}
    states = {}
    stubs = [StubReplica(f"s{i}") for i in range(3)]
    try:
        ha = str(tmp_path / "ha")
        lost, moved = _ha_primary(mods[writer], stubs, ha)
        assert len(lost) >= 2 and moved
        shutil.copytree(ha, str(tmp_path / "ha_copy"))
        n_stream = [len(s.stream_headers) for s in stubs]
        for pkg, d in ((writer, str(tmp_path / "ha_copy")), (reader, ha)):
            # each standby starts from the same stub state
            for s, n in zip(stubs, n_stream):
                del s.stream_headers[n:]
                s.sessions[:] = s.sessions[:n]
            states[pkg] = _ha_takeover(mods[pkg], stubs, d, lost, moved)
    finally:
        for s in stubs:
            try:
                s.kill()
            except Exception:
                pass
    assert states[reader] == states[writer]
    assert states[reader]["answers"][:2] == [(lost[0], 200),
                                             (lost[0], 200)]
    assert states[reader]["answers"][2:4] == [(lost[1], 410),
                                              (lost[1], 200)]
    assert states[reader]["adopted"] == (200, "k-" + "ab" * 8)


# ----------------------------------------------------------------- rollout
ROLLOUT_TESTS = [
    ("test_models", "test_rollout_assignment_is_deterministic"),
    ("test_models", "test_rollout_requires_explicit_version"),
    ("test_models", "test_rollout_demotion_needs_sustained_regression"),
    ("test_models", "test_rollout_recovery_resets_dwell"),
    ("test_confidence", "test_rollout_shadow_confidence_drop_demotes"),
]


@pytest.mark.parametrize("module,name", ROLLOUT_TESTS,
                         ids=[n for _, n in ROLLOUT_TESTS])
def test_rollout_counterpart(module, name):
    port_twin(module, name)()


def _policies(**cfg):
    t = {"t": 0.0}
    return [m.RolloutPolicy(m.RolloutConfig(**cfg), clock=lambda: t["t"])
            for m in (jrollout, prollout)], t


@pytest.mark.parametrize("fraction,shadow", [(0.05, 0.1), (0.3, 0.2),
                                             (0.9, 0.0)])
def test_rollout_assigns_the_bodies_jax_assigns(fraction, shadow):
    (j, p), _ = _policies()
    for pol in (j, p):
        pol.set_canary("kitti@v2", fraction, shadow_fraction=shadow)
    rng = np.random.default_rng(int(fraction * 100))
    bodies = [rng.bytes(int(rng.integers(1, 64))) for _ in range(2000)]
    assert [p.assign(b) for b in bodies] == [j.assign(b) for b in bodies]
    assert [p.wants_shadow(b) for b in bodies] == \
        [j.wants_shadow(b) for b in bodies]
    assert p.status() == j.status()


def test_rollout_demotes_on_the_sequences_jax_demotes():
    """The same evidence, step for step: outcomes, shadow EPEs and
    confidence deltas at a fake clock; the status after every step
    equal, demotions included."""
    (j, p), t = _policies(min_samples=4, error_threshold=0.5,
                          epe_threshold=1.0, confidence_threshold=0.2,
                          demote_after_s=2.0, window=8)
    rng = np.random.default_rng(5)
    for pol in (j, p):
        pol.set_canary("kitti@v2", 0.4, shadow_fraction=0.5)
    steps = 0
    for phase in range(6):
        if phase == 3:
            for pol in (j, p):
                pol.set_canary("kitti@v3", 0.2, shadow_fraction=0.3)
        for _ in range(12):
            kind = int(rng.integers(3))
            val = float(rng.uniform(0, 3))
            for pol in (j, p):
                if kind == 0:
                    pol.note_canary_result(val < 1.0 + phase % 2)
                elif kind == 1:
                    pol.note_shadow_epe(val)
                else:
                    pol.note_shadow_confidence(val / 6)
            t["t"] += 0.5
            assert p.poll() == j.poll()
            assert p.status() == j.status()
            steps += 1
    assert j.status()["demotions"] >= 1 and steps == 72


# --------------------------------------------------------------- autoscaler
def _scaled(pkg, trace):
    fleet = {JAX: jfleet, PORT: pfleet}[pkg]
    mod = {JAX: jautoscaler, PORT: pautoscaler}[pkg]
    base = StubReplica("base0")
    router = fleet.FleetRouter({"base0": base.url},
                               fleet.RouterConfig(**BASE))
    launcher = RecordingLauncher()
    clock = FakeClock(t=0.0)
    it = iter(trace)
    scaler = mod.Autoscaler(
        router, launcher,
        mod.AutoscaleConfig(min_replicas=1, max_replicas=3,
                            engage_fraction=0.6, engage_s=1.0,
                            restore_fraction=0.15, restore_s=2.0,
                            cooldown_s=0.5),
        clock=clock, pressure_fn=lambda: next(it, trace[-1]))
    steps = []
    try:
        router.check_replicas()
        for k in range(len(trace)):
            action = scaler.check()
            if action == "down" and k % 3 == 0:
                launcher.finish_drain(launcher.drained[-1])
            steps.append((action, sorted(router.replicas),
                          scaler.launched, scaler.draining,
                          scaler.pressure_gauge.value))
            clock.t += 0.4
        # destroy() only reaps a drained replica whose process exited
        assert set(launcher.killed) <= set(launcher.exited)
        return steps, list(launcher.drained), list(launcher.killed), \
            router.registry.render_text()
    finally:
        launcher.cleanup()
        router.stop()
        base.kill()


def test_autoscaler_decisions_equal_to_jax():
    """JAX's scripted-trace shapes (blips, sustained pressure, the dead
    band, sustained calm) and a seeded random walk: the port's decisions,
    membership, drains and reaps step for step JAX's; a replica is only
    destroyed after its drain exited."""
    rng = np.random.default_rng(11)
    walk = list(np.clip(np.cumsum(rng.normal(0, 0.2, 60)) + 0.5, 0, 1))
    trace = ([0.9, 0.1, 0.9, 0.9, 0.9, 0.4, 0.4] + [0.05] * 8
             + [0.95] * 12 + [0.0] * 16 + [float(x) for x in walk])
    want = _scaled(JAX, trace)
    got = _scaled(PORT, trace)
    assert got == want
    actions = [s[0] for s in got[0]]
    assert actions.count("up") >= 2 and actions.count("down") >= 2
    assert got[1] and got[2]


# --------------------------------------------------------------------- CLI
def _dests(parser):
    return {a.dest: a.default for a in parser._actions
            if a.dest != "help"}


def test_route_cli_flags_and_defaults_equal_to_jax():
    from raft_stereo_tpu.cli import route as jroute
    from raft_stereo_tpu_torch.cli import route as proute
    assert _dests(proute.build_parser()) == _dests(jroute.build_parser())
    argv = ["--replica", "http://127.0.0.1:1", "--replica",
            "named=http://127.0.0.1:2", "--canary", "kitti@v2=0.05",
            "--canary_shadow", "0.1", "--trace_sample_rate", "0.5",
            "--slo_ms", "250", "--no-fleet_brownout"]
    jr = jroute.build_router(jroute.build_parser().parse_args(argv))
    pr = proute.build_router(proute.build_parser().parse_args(argv))
    assert pr.cfg.__dict__ == jr.cfg.__dict__
    assert {n: r.url for n, r in pr.replicas.items()} == \
        {n: r.url for n, r in jr.replicas.items()}
    assert scrub(pr.rollout.status()) == scrub(jr.rollout.status())
    for bad in ("kitti@v2", "kitti@v2=x", "kitti@v2=1.5"):
        for mod in (jroute, proute):
            with pytest.raises(Exception):
                mod.parse_canary(bad)


def test_route_cli_launches_the_ports_replicas(tmp_path):
    """The autoscaler built from ``--autoscale_cmd`` launches what the
    template names: with the port's template, the port's serve CLI under
    this interpreter."""
    from raft_stereo_tpu_torch.cli import route as proute
    args = proute.build_parser().parse_args([
        "--replica", "http://127.0.0.1:1", "--autoscale_cmd",
        "python -m raft_stereo_tpu_torch.cli.serve --restore_ckpt ck "
        "--port {port} --sessions", "--autoscale_log_dir", str(tmp_path)])
    router = proute.build_router(args)
    scaler = proute.build_autoscaler(args, router)
    assert isinstance(scaler.launcher, pfleet.LocalProcessLauncher)
    assert scaler.launcher.argv_for("auto1", 8123) == [
        sys.executable, "-m", "raft_stereo_tpu_torch.cli.serve",
        "--restore_ckpt", "ck", "--port", "8123", "--sessions"]
    assert scaler.cfg == pautoscaler.AutoscaleConfig()
    assert proute.build_autoscaler(
        proute.build_parser().parse_args(["--replica", "x"]), router) is None


def test_serve_argv_template_names_the_port():
    argv_for = pfleet.serve_argv_template(
        "python -m raft_stereo_tpu_torch.cli.serve --port {port} "
        "--name {name}")
    assert argv_for("r7", 9001) == [
        sys.executable, "-m", "raft_stereo_tpu_torch.cli.serve", "--port",
        "9001", "--name", "r7"]
    with pytest.raises(ValueError, match="port"):
        pfleet.serve_argv_template("python -m x")


def test_local_launcher_drains_by_sigterm(tmp_path):
    """``LocalProcessLauncher``: launch, poll while running, drain with
    SIGTERM (exit code seen by poll), destroy; logs under its dir."""
    script = ("import signal, sys, time\n"
              "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
              "print('port', sys.argv[1], flush=True)\n"
              "time.sleep(60)\n")
    launcher = pfleet.LocalProcessLauncher(
        lambda name, port: [sys.executable, "-c", script, str(port)],
        log_dir=str(tmp_path))
    url = launcher.launch("a")
    assert url.startswith("http://127.0.0.1:")
    assert launcher.poll("a") is None and launcher.poll("b") is None
    import time
    time.sleep(0.5)
    launcher.drain("a")
    for _ in range(100):
        if launcher.poll("a") is not None:
            break
        time.sleep(0.05)
    assert launcher.poll("a") == 0
    launcher.stop_all()
    with open(os.path.join(str(tmp_path), "a.log")) as f:
        assert f.read().split() == ["port", url.rsplit(":", 1)[1]]


def test_fleet_exports_equal_jax():
    assert pfleet.__all__ == jfleet.__all__
    for name in pfleet.__all__:
        obj = getattr(pfleet, name)
        if name == "DEFAULT_VNODES":
            assert obj == jfleet.DEFAULT_VNODES
        else:
            assert obj.__module__.startswith(PORT), name


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_standby_fetching_a_manifest_first_costs_the_primary_its_handoff(
        pkg, tmp_path):
    """The reference's HA pair behaviour, kept by the port (ROADMAP §C):
    both routers fetch a draining replica's manifest; when the standby's
    fetch comes first and the replica then exits, the primary finds it
    gone and types its sessions lost."""
    fleet = {JAX: jfleet, PORT: pfleet}[pkg]
    stubs = [StubReplica(f"s{i}") for i in range(2)]
    urls = {s.name: s.url for s in stubs}
    ha = str(tmp_path)
    primary = fleet.FleetRouter(urls, fleet.RouterConfig(
        ha_dir=ha, router_name="rt-a", **BASE))
    standby = fleet.FleetRouter(urls, fleet.RouterConfig(
        ha_dir=ha, router_name="rt-b", standby=True, **BASE))
    try:
        primary.check_replicas()
        standby.check_replicas()
        for i in range(8):
            primary.forward_session(f"c{i}", "POST", f"/v1/stream/c{i}",
                                    b"f", [])
        victim = stubs[0]
        moved = list(victim.sessions)
        victim.draining = True
        victim.handoff_manifest = {"artifact": "k", "sessions": moved,
                                   "count": len(moved)}
        standby.check_replicas()
        victim.kill()
        primary.check_replicas()
        st = primary.fleet_status()
        assert moved and st["sessions_pending_loss"] == len(moved)
        assert st["sessions_pending_handoff"] == 0
        assert standby.fleet_status()["sessions_pending_handoff"] == \
            len(moved)
    finally:
        primary.stop()
        standby.stop()
        for s in stubs[1:]:
            s.kill()
