"""The port's fleet observability against the JAX package's, on the CPU:
label injection and metrics federation, burn rates and the SLO watchdog
under the router, span trees across the router hop, and the coordinated
flight-recorder dump.

The JAX package's tests (``tests/test_fleet_observability.py``) run again
re-bound to the port (``torch_fleet_support.port_twin``).  Two of them
read the router's span ring as soon as the response arrives, while the
router finishes the root span after writing the response (a race of
those tests: ROADMAP §C4); their counterparts here poll the ring for the
root span with a deadline instead (``torch_fleet_support.root_spans``).
"""

import json

import pytest

from raft_stereo_tpu_torch.serving import fleet as pfleet
from raft_stereo_tpu_torch.telemetry.spans import decode_traceparent
from torch_fleet_support import (BASE, call, fleet3,  # noqa: F401
                                 port_twin, root_spans, span_tree)

OBS = "test_fleet_observability"
NOARG_TESTS = [
    "test_inject_label_no_labelset",
    "test_inject_label_existing_labelset",
    "test_inject_label_empty_labelset",
    "test_inject_label_brace_inside_quoted_value",
    "test_inject_label_value_escaping_round_trips",
    "test_relabel_exposition_dedups_help_type_across_replicas",
    "test_federator_marks_dead_replica_stale_then_ages_out",
    "test_federator_render_dedups_families_across_replicas_and_own",
    "test_burn_rate_tracker_windows_and_clamp",
    "test_burn_rate_fast_window_forgets_old_errors",
    "test_slo_watchdog_requires_both_windows_then_rearms",
    "test_traceparent_round_trip",
    "test_traceparent_lenient_widths_and_flags",
]
FLEET3_TESTS = [
    "test_router_rate_zero_keeps_forwarding_untraced",
    "test_router_error_paths_carry_trace_id_and_burn_budget",
    "test_router_metrics_fleet_federates_stub_series",
    "test_router_federated_spans_merge_replica_ring",
    "test_fleet_status_and_replica_probe_stats",
]


@pytest.mark.parametrize("name", NOARG_TESTS)
def test_observability_counterpart(name):
    port_twin(OBS, name)()


@pytest.mark.parametrize("name", FLEET3_TESTS)
def test_observability_counterpart_on_three_stubs(name, fleet3):
    port_twin(OBS, name)(fleet3)


def test_watchdog_dump_counterpart(fleet3, tmp_path):
    port_twin(OBS, "test_watchdog_triggers_coordinated_fleet_dump")(
        fleet3, tmp_path)


def _traced(stubs):
    router = pfleet.FleetRouter(
        {s.name: s.url for s in stubs},
        pfleet.RouterConfig(**dict(BASE, trace_sample_rate=1.0,
                                   slo_ms=10_000.0)))
    router.check_replicas()
    return router, pfleet.RouterHTTPServer(router, port=0).start()


def test_router_trace_spans_and_header_propagation(fleet3):
    """A sampled request: ``X-Trace-Id`` echoed, the forwarded hop's
    ``traceparent`` names the same trace with the ``route.forward`` span
    as parent, and the ring holds the whole tree under one root."""
    stubs, _ = fleet3
    router, server = _traced(stubs)
    try:
        status, headers, _ = call(f"{server.url}/v1/disparity", "POST",
                                  b"px")
        assert status == 200
        tid = headers["X-Trace-Id"]
        fwd = [h for s in stubs for h in s.stateless_headers]
        assert len(fwd) == 1
        ctx = decode_traceparent(fwd[0].get("traceparent"))
        assert ctx is not None and ctx.trace_id == tid
        spans = root_spans(router.tracer, tid)
        tree = span_tree(spans)
        assert [(n, p) for n, p, _ in tree] == [
            ("route.forward", "route.request"),
            ("route.pick", "route.request"),
            ("route.request", None),
            ("route.respond", "route.request")]
        assert ctx.parent_span_id == next(
            s["span_id"] for s in spans if s["name"] == "route.forward")
        status, _, body = call(f"{server.url}/debug/spans?trace={tid}")
        view = json.loads(body)
        assert status == 200 and all(s["trace_id"] == tid
                                     for s in view["spans"])
        assert {s["name"] for s in view["spans"]} == {n for n, _, _ in tree}
    finally:
        server.shutdown()
        router.stop()


def test_failover_retry_is_two_forward_children_one_trace(fleet3):
    """A transport failover inside one request: two ``route.forward``
    children (the first ``error=transport``, the second 200) under one
    root, all under the request's trace id."""
    stubs, _ = fleet3
    router, server = _traced(stubs)
    try:
        stubs[0].kill()
        retried = 0
        for _ in range(6):
            status, headers, _ = call(f"{server.url}/v1/disparity",
                                      "POST", b"px")
            assert status == 200
            tid = headers["X-Trace-Id"]
            spans = root_spans(router.tracer, tid)
            assert all(s["trace_id"] == tid for s in spans)
            root = [s for s in spans if s["name"] == "route.request"]
            assert len(root) == 1
            fwd = [s for s in spans if s["name"] == "route.forward"]
            if len(fwd) == 2:
                retried += 1
                assert [s["attrs"].get("error") for s in fwd] == \
                    ["transport", None]
                assert [s["attrs"].get("status") for s in fwd] == \
                    [None, 200]
                assert all(s["parent_id"] == root[0]["span_id"]
                           for s in fwd)
        assert retried == 1, "only the first pick of the dead stub retries"
        assert not router.replicas["s0"].alive
    finally:
        server.shutdown()
        router.stop()
